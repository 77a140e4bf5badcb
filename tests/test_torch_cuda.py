"""Kernel parity on an NVIDIA GPU: the CUDA Psi-statistics kernels against
their plain PyTorch versions (the cases of chip_smoke.py phase 3), and the
kernel wrappers' input checks. Skipped without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gparml_tpu_torch.ops import psi_cuda  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(device, n=40, m=30, q=4, d=5, dtype=torch.float32):
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (t(rng.standard_normal((n, q))), t(0.3 + rng.random((n, q))),
            t(rng.standard_normal((m, q))), t(1.3), t(0.5 + rng.random(q)),
            t(rng.standard_normal((n, d))), t(np.ones(n)))


@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES, ids=str)
def test_kernel_parity(cuda, case):
    chip_smoke.parity_case(*case, device=cuda)


def test_wrappers_count_launches(cuda):
    xs = _inputs(cuda)
    before = dict(psi_cuda.LAUNCHES)
    p1y, p2 = psi_cuda.psi_fwd(*xs)
    psi_cuda.psi_bwd(*xs, p1y, p2, torch.ones_like(p1y), torch.ones_like(p2))
    torch.cuda.synchronize()
    assert psi_cuda.LAUNCHES["fwd"] == before["fwd"] + 1
    assert psi_cuda.LAUNCHES["bwd"] == before["bwd"] + 1


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    xs = _inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        psi_cuda.psi_fwd(*_inputs(cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        psi_cuda.psi_fwd(xs[0].T.contiguous().T, *xs[1:])
    with pytest.raises(ValueError, match="shape"):
        psi_cuda.psi_fwd(*xs[:6], xs[6][:-1])
    with pytest.raises(ValueError, match="one CUDA device"):
        psi_cuda.psi_fwd(xs[0].cpu(), *xs[1:])


# Z staged as M x 64 floats (1 MB), and 32 rows of Y as 32 x D floats
# (2.5 MB): both past any card's shared memory per block.
@pytest.mark.parametrize("m, q, d", [(4000, 64, 4), (40, 10, 20000)])
def test_wrappers_reject_shapes_past_shared_memory(cuda, m, q, d):
    xs = _inputs(cuda, n=8, m=m, q=q, d=d)
    before = dict(psi_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        psi_cuda.psi_fwd(*xs)
    m_ok = torch.zeros((m, m), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        psi_cuda.psi_bwd(*xs, torch.zeros((m, d), device=cuda), m_ok,
                         torch.zeros((m, d), device=cuda), m_ok)
    assert psi_cuda.LAUNCHES == before
