"""The port's entry points (``gparml_tpu_torch/graft_entry.py``), the
counterparts of tests/test_graft_entry.py: ``entry()`` runs one bound and
gradient evaluation, ``dryrun_multichip`` a GPLVM, SGPR and SVGP step over
a mesh of eight CPU shards, ``dryrun_multihost`` the CLI's remote mode on
two gloo processes; and ``entry()`` computes what the JAX package's
``__graft_entry__.entry()`` computes on the same inputs."""

import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gparml_tpu_torch import graft_entry  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Each dry run across processes gets this long before its ranks are killed.
MULTIHOST_TIMEOUT = 120


def test_entry_runs_small():
    fn, args = graft_entry.entry(device="cpu")
    f, grads = fn(*args)
    assert np.isfinite(float(f))
    assert grads[0].shape == args[0].glob.z.shape
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


def test_entry_without_a_card_raises(monkeypatch):
    """The default device is the card: without one entry() raises and
    names the CPU, it does not run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()


def test_dryrun_multichip_eight():
    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert set(out) == {"gplvm", "sgpr", "svgp"}
    assert all(np.isfinite(v) for v in out.values())


def test_dryrun_multihost():
    """Two CLI ranks over gloo: the summary counts 2 devices, and the dry
    run checks the bound, both ranks' embeddings partitions and the
    coordinator's checkpoint."""
    summary = graft_entry.dryrun_multihost(2, 1, device="cpu", timeout=MULTIHOST_TIMEOUT)
    assert summary["devices"] == 2 and summary["processes"] == 2
    assert summary["globals_agree"]


def test_dryrun_multihost_refuses_several_devices_a_process():
    """A -p remote rank has one device: more raises and names the limit
    rather than running one shard and ignoring the rest."""
    with pytest.raises(ValueError, match="one device"):
        graft_entry.dryrun_multihost(2, 2, device="cpu")


@pytest.mark.parametrize("code, timeout, what", [
    ("import os, sys, time\nif os.environ['RANK'] == '1': sys.exit(3)\ntime.sleep(60)", 30,
     "rank 1 failed"),
    ("import time; time.sleep(60)", 2, "timed out after 2 s"),
], ids=["rank_fails", "timeout"])
def test_run_ranks_kills_the_other_ranks(tmp_path, code, timeout, what):
    """When a rank fails, or the time runs out, every rank still running is
    killed at once (not left waiting in a collective) and the error names
    what happened, with each rank's exit code."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=what) as err:
        graft_entry.run_ranks(["-c", code], 2, str(tmp_path), "probe", timeout)
    assert time.monotonic() - t0 < 20
    assert "rank 0 (rc=" in str(err.value) and "rank 1 (rc=" in str(err.value)


def test_run_ranks_returns_each_rank_output(tmp_path):
    outs = graft_entry.run_ranks(
        ["-c", "import os; print('rank', os.environ['RANK'], 'of', os.environ['WORLD_SIZE'])"],
        2, str(tmp_path), timeout=30)
    assert [o.strip() for o in outs] == ["rank 0 of 2", "rank 1 of 2"]


def test_entry_matches_the_jax_graft_entry():
    """The JAX package's ``__graft_entry__.entry()`` inputs, carried across
    by ``params.from_numpy``: the port's -bound and every gradient leaf
    against the JAX package's, both in float32 on the CPU (value rtol 1e-5;
    each leaf within 1e-4 of its max, norm-scaled, the reference's float32
    gradient tolerance)."""
    import __graft_entry__ as ge

    fn_j, (p_j, y_j) = ge.entry()
    f_j, g_j = jax.jit(fn_j)(p_j, y_j)
    fn, _ = graft_entry.entry(device="cpu")
    p = TP.from_numpy(jax.tree.map(np.asarray, p_j), device="cpu", dtype=torch.float32)
    f, grads = fn(p, torch.tensor(np.asarray(y_j)))
    np.testing.assert_allclose(float(f), float(f_j), rtol=1e-5)
    for got, want in zip(grads, jax.tree.leaves(g_j)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.double().numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-4, (got.shape, err)
