"""The port across processes: two ranks of a ``gloo`` process group on the
CPU, the counterparts of tests/test_multihost.py, and the two properties a
process group must keep that one process cannot show:

  * the two-rank float64 gradient of every leaf equals one process's at
    rtol 1e-10 (the replicated leaves' gradients are summed once, their
    direct part added once: a K-fold term would show here);
  * after an SCG fit both ranks hold the same globals, bit for bit (every
    scalar of the loop is summed over the ranks).

The CLI runs as ``python -m gparml_tpu_torch.cli --device cpu -p remote``
with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set, as torchrun sets
them. Every spawned process has a timeout, and both are killed when one
expires."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gparml_tpu_torch import cli as tcli  # noqa: E402
from gparml_tpu_torch import data as tdata  # noqa: E402
from gparml_tpu_torch import graft_entry  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.models import sgpr as ts  # noqa: E402
from gparml_tpu_torch.parallel import distributed  # noqa: E402
from tests import torch_multihost_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _two_ranks(args):
    """Run ``python *args`` as ranks 0 and 1 of a new group; returns their
    outputs, and fails with both outputs unless both exit 0 within
    TIMEOUT."""
    return graft_entry.run_ranks(args, 2, timeout=TIMEOUT, env={"OMP_NUM_THREADS": "1"})


def _remote_cli(cli_args):
    """The CLI under -p remote on two ranks: (rank 0's summary, outputs)."""
    outs = _two_ranks(["-m", "gparml_tpu_torch.cli", "--device", "cpu", "-p", "remote",
                       *map(str, cli_args)])
    summary = json.loads([line for line in outs[0].splitlines() if line.startswith("{")][-1])
    return summary, outs


def _local_cli(cli_args):
    return tcli.main(["--device", "cpu", *map(str, cli_args)])


def test_backend_rule_and_no_group_without_variables(monkeypatch):
    """gloo on the CPU and where ranks share a card, nccl where each has
    its own; no process group without an address, a size and a rank."""
    assert distributed.backend_for("cpu", 1, 8) == "gloo"
    assert distributed.backend_for("cuda", 2, 1) == "gloo"
    assert distributed.backend_for("cuda", 1, 1) == "nccl"
    assert distributed.backend_for("cuda", 4, 4) == "nccl"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize(device_type="cpu")
    assert not distributed.is_initialized() and distributed.process_count() == 1
    assert distributed.process_row_range(29, 4) == (0, 32, 32)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="coordinator's address"):
        distributed.initialize(device_type="cpu")
    mesh = distributed.global_mesh("cpu")
    assert mesh.group is None and mesh.size == 1
    assert distributed.broadcast_pytree({"a": 1}) == {"a": 1}


def test_initialize_without_a_card_raises(monkeypatch):
    """The default device type is 'cuda': without a card initialize raises,
    as local_device does, whether or not the variables ask for a group, and
    joins none; 'cpu' is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(graft_entry._free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    assert not distributed.is_initialized()


@pytest.fixture(scope="module")
def two_rank_api(tmp_path_factory):
    """Both ranks' outputs of tests/torch_multihost_worker.py."""
    out = tmp_path_factory.mktemp("api")
    _two_ranks([os.path.join(ROOT, "tests", "torch_multihost_worker.py"), str(out)])
    return [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]


def _one_process():
    """The worker's problem in one process, without a mesh."""
    y, arrays, x, x_star, y_new = worker.problem()
    p = TP.from_numpy(arrays, device="cpu", dtype=torch.float64)
    cfg = tg.GPLVMConfig(q=worker.Q, num_inducing=worker.M)
    yt = torch.tensor(y)
    f, grads = tg.neg_bound_value_and_grad(p, yt, cfg)
    f_s, grads_s = ts.neg_bound_value_and_grad(
        p.glob, torch.tensor(x), yt, ts.SGPRConfig(num_inducing=worker.M))
    mean, var = tg.predict_observed(p, yt, torch.tensor(x_star), cfg)
    mu_new, _, inferred = tg.infer_latents(p, yt, torch.tensor(y_new), cfg, iters=3)
    res = tg.fit(p, yt, cfg, iters=worker.FIT_ITERS)
    return dict(f=float(f), grads=grads, f_sgpr=float(f_s), grads_sgpr=grads_s, mean=mean,
                var=var, mu_new=mu_new, infer_history=inferred.history, history=res.history)


def test_two_rank_gradients_match_one_process(two_rank_api):
    """The two-stage gradient of every leaf, GPLVM and SGPR, on both ranks,
    against one process at rtol 1e-10; each rank's latent rows are its own
    block of the one-process gradient, its padded row exactly 0. Also the
    predictions and the latents inferred from the summed statistics."""
    ref = _one_process()
    n = worker.N
    for out in two_rank_api:
        np.testing.assert_allclose(out["f"], ref["f"], rtol=1e-12)
        np.testing.assert_allclose(out["f_sgpr"], ref["f_sgpr"], rtol=1e-12)
        start, stop = out["rows"]
        for i, g in enumerate(ref["grads"]):
            got, want = out[f"grad_{i}"], g.numpy()
            if i >= 4:   # the latents: this rank's rows, then its padding
                want = want[start:min(stop, n)]
                assert np.count_nonzero(got[len(want):]) == 0
                got = got[:len(want)]
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       atol=1e-13 * np.abs(want).max(), err_msg=f"leaf {i}")
        for i, g in enumerate(ref["grads_sgpr"]):
            np.testing.assert_allclose(out[f"grad_sgpr_{i}"], g.numpy(), rtol=1e-10)
        for key in ("mean", "var"):
            np.testing.assert_allclose(out[key], ref[key].detach().numpy(), rtol=1e-10)
        # three SCG iterations of infer_latents: a trajectory, held as the
        # GPLVM SCG trajectories are (tests/test_torch_gplvm.py)
        np.testing.assert_allclose(out["mu_new"], ref["mu_new"].numpy(), rtol=1e-8)
        np.testing.assert_allclose(out["infer_history"], ref["infer_history"], rtol=1e-8)


def test_two_rank_scg_fit_keeps_globals_bitwise_equal(two_rank_api):
    """After SCG on two ranks both hold the same globals bit for bit, and
    the trajectory is one process's."""
    r0, r1 = two_rank_api
    for i in range(4):
        np.testing.assert_array_equal(r0[f"fit_{i}"], r1[f"fit_{i}"])
    np.testing.assert_array_equal(r0["history"], r1["history"])
    h = _one_process()["history"]
    np.testing.assert_allclose(r0["history"], h, rtol=1e-8)


@pytest.fixture
def sgpr_folders(tmp_path, rng):
    x = np.sort(rng.uniform(-2, 2, (96, 1)), axis=0)
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((96, 1))
    inputs, emb = tmp_path / "inputs", tmp_path / "emb"
    tdata.save_partitioned(str(inputs), y, 3, prefix="Y")
    tdata.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=3)
    return tmp_path, inputs, emb


def test_remote_bound_matches_local(sgpr_folders):
    """The same checkpointed parameters give the same bound from one
    process (-p local) and two (-p remote), in float64."""
    tmp_path, inputs, emb = sgpr_folders
    base = ["-i", inputs, "-e", emb, "-s", tmp_path / "st", "-q", 1, "-m", 8,
            "--fixed-embeddings", "--dtype", "float64"]
    _local_cli(base + ["-T", 10])
    local = _local_cli(base + ["-T", 0, "--load"])
    remote, outs = _remote_cli(base + ["-T", 0, "--load"])
    assert remote["devices"] == 2 and remote["parallel"] == "remote"
    assert remote["backend"] == "gloo" and remote["globals_agree"]
    assert all("backend gloo" in text for text in outs)
    np.testing.assert_allclose(remote["final_bound"], local["final_bound"], rtol=1e-9)


def test_remote_gplvm_train_save_resume(tmp_path):
    """The GPLVM workflow on two ranks: each initialises from its rows, fits,
    writes its own embeddings partition; the coordinator writes a
    checkpoint of the globals only; two ranks resume from it, and so does
    one process under -p local."""
    y, _ = tdata.synthetic_gplvm(n=64, d=5, q_true=2, seed=7)
    inputs, emb, st = tmp_path / "inputs", tmp_path / "emb", tmp_path / "st"
    tdata.save_partitioned(str(inputs), y, 4, prefix="Y")
    base = ["-i", inputs, "-e", emb, "-s", st, "-q", 2, "-m", 6, "--dtype", "float64"]
    s1, outs = _remote_cli(base + ["-T", 6])
    assert np.isfinite(s1["final_bound"]) and s1["devices"] == 2
    digests = [line.split()[-1] for text in outs for line in text.splitlines()
               if "globals sha256" in line]
    assert len(digests) == 2 and digests[0] == digests[1]
    assert np.load(emb / "X_mu_0.npy").shape == (32, 2)
    assert np.load(emb / "X_mu_1.npy").shape == (32, 2)
    with np.load(st / "checkpoint.npz") as f:
        assert "z" in f.files and not any(k.startswith("lat") for k in f.files)

    s2, _ = _remote_cli(base + ["-T", 4, "--load"])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-6
    s3 = _local_cli(base + ["-T", 2, "--load"])
    assert s3["final_bound"] >= s2["final_bound"] - 1e-6


def test_remote_svgp_train_resume(sgpr_folders):
    """SVGP over two ranks (--optimizer svgp -p remote): each rank draws
    windows from its own rows, the data term's gradient is summed over the
    ranks and the KL's added once, so both end with the same glob, q_mu and
    q_sqrt bit for bit (the CLI raises otherwise); then both resume from the
    coordinator's checkpoint."""
    tmp_path, inputs, emb = sgpr_folders
    st = tmp_path / "svst"
    base = ["-i", inputs, "-e", emb, "-s", st, "-m", 8, "--fixed-embeddings",
            "--optimizer", "svgp", "--batch-size", 32, "--learning-rate", 0.05]
    s1, outs = _remote_cli(base + ["-T", 40])
    assert np.isfinite(s1["final_elbo"]) and s1["devices"] == 2
    assert s1["parallel"] == "remote" and s1["globals_agree"] and s1["backend"] == "gloo"
    assert s1["final_elbo_exact"] is True and s1["final_elbo_n"] == 96
    digests = [line.split()[-1] for text in outs for line in text.splitlines()
               if "globals sha256" in line]
    assert len(digests) == 2 and digests[0] == digests[1]
    with np.load(st / "checkpoint.npz") as f:
        assert f["q_sqrt"].shape == (1, 8, 8) and f["q_mu"].shape == (8, 1)
    s2, _ = _remote_cli(base + ["-T", 20, "--load"])
    assert s2["iterations"] == 20 and s2["globals_agree"]
    assert s2["final_elbo"] >= s1["final_elbo"] - 5.0