"""The Q <= 64 tensor-core arithmetic of Psi2 and Psi1 on latents spread as
a fit spreads them, against the JAX package's own float32 path.

At spread 3 (``chip_smoke.spread_inputs``: latents 3 * N(0, 1), each
inducing point near a latent row, N=400, M=64, D=16) the expanded
exponent's terms c mu' z' grow with the spread while the exponent does not,
and the CPU model of the kernels (``ops/psi_tc_model.py``: ``psi2_vjp``,
``psi1_vjp``) reads several times the plain float32 engine's error at
Q = 32-64. The plain engine is not the reference, though: the JAX
package's float32 path is, its Pallas kernels run in interpret mode as
tests/test_torch_psi.py runs them (at M=64, Ml=128: ``_fwd_kernel`` and
``_bwd_kernel``, outside the flat window). Each leaf, norm-scaled against
the JAX package's float64 VJP, is held to the larger of ``F64_TOL`` and
``F64_FLOOR_FACTOR`` times the reference's error on the same inputs
(``tools/spread_latents.py`` prints them all).

The reference's error of a per-row or per-point leaf (the statistic, dmu,
ds, dZ, dY) is read at seed 0. dsf2 and dalpha are sums over every row and
inducing point, and the error of such a sum is one draw of a cancelling
sum: at Q=32 the reference's dsf2 of Psi1 reads 3.4e-6 at seed 0 and
4.5e-5 to 1.7e-4 at seeds 1-4, while the model's reads 2.4e-5 at seed 0.
So for those two leaves both the model's and the reference's errors are
the median over ``tools/spread_latents.SEEDS`` (seeds 0-4), each leaf still
held against the reference's error of the same leaf. Q=10 is the control.
Every assertion message carries the model's, the plain float32 engine's
and the reference's errors."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gparml_tpu.ops import psi_pallas  # noqa: E402
from tools import spread_latents as sl  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("stat", sl.STATS)
@pytest.mark.parametrize("q", sl.CASES)
def test_model_within_the_reference_float32_error_on_spread_latents(q, stat):
    assert not psi_pallas._use_flat(128, q, interpret=True)
    errs = sl.cpu_errors(q, stat)
    limits = sl.limits(errs, chip_smoke.F64_FLOOR_FACTOR, chip_smoke.F64_TOL)
    for name, (model, plain, ref) in errs.items():
        assert model <= limits[name], (
            f"Q={q} {stat} d{name}: model {model:.2e}, plain f32 {plain:.2e}, "
            f"JAX Pallas f32 {ref:.2e} (limit {limits[name]:.2e}); all leaves {errs}")
