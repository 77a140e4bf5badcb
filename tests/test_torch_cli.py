"""The port's partition-folder CLI (GPLVM mode) and its modules against the
JAX package on the CPU: data IO, checkpoints, logging, the Adam/GD
optimizers, the host-side inducing-point candidates and the CLI itself.
Mirrors the GPLVM cases of tests/test_io_cli.py; the port's CLI runs with
``--device cpu``."""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu import checkpoint as jckpt  # noqa: E402
from gparml_tpu import cli as jcli  # noqa: E402
from gparml_tpu import data as jdata  # noqa: E402
from gparml_tpu.models import gplvm as jg  # noqa: E402
from gparml_tpu.models import params as JP  # noqa: E402
from gparml_tpu.utils import init as jinit  # noqa: E402
from gparml_tpu.utils import logging as jlog  # noqa: E402
from gparml_tpu_torch import checkpoint as tckpt  # noqa: E402
from gparml_tpu_torch import cli as tcli  # noqa: E402
from gparml_tpu_torch import data as tdata  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.utils import init as tinit  # noqa: E402
from gparml_tpu_torch.utils import logging as tlog  # noqa: E402

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _history(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# --- data and checkpoints (tests/test_io_cli.py) ----------------------------

def test_partitioned_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((103, 4))
    paths = tdata.save_partitioned(str(tmp_path), arr, 7, prefix="Y")
    assert len(paths) == 7
    np.testing.assert_array_equal(tdata.load_partitioned(str(tmp_path), prefix="Y"), arr)
    # the JAX package reads the port's folder, and its row loaders agree
    np.testing.assert_array_equal(jdata.load_partitioned(str(tmp_path), prefix="Y"), arr)
    assert tdata.partition_rows(str(tmp_path), prefix="Y") == 103
    np.testing.assert_array_equal(tdata.load_rows(str(tmp_path), 10, 61, prefix="Y"),
                                  jdata.load_rows(str(tmp_path), 10, 61, prefix="Y"))


def test_embeddings_roundtrip(tmp_path, rng):
    mu = rng.standard_normal((50, 3))
    s = rng.uniform(0.1, 1.0, (50, 3))
    jdata.save_embeddings(str(tmp_path / "j"), mu, s, n_partitions=4)
    tdata.save_embeddings(str(tmp_path / "t"), mu, s, n_partitions=4)
    for folder in ("j", "t"):
        mu2, s2 = tdata.load_embeddings(str(tmp_path / folder))
        np.testing.assert_array_equal(mu2, mu)
        np.testing.assert_array_equal(s2, s)
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == sorted(
        p.name for p in (tmp_path / "t").iterdir())
    tdata.save_embeddings_partition(str(tmp_path / "p"), mu[:7], s[:7], partition=2)
    mu3, s3 = tdata.load_embeddings_rows(str(tmp_path / "p"), 0, 7)
    np.testing.assert_array_equal(mu3, mu[:7])
    np.testing.assert_array_equal(s3, s[:7])


def test_missing_partition_folder_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdata.load_partitioned(str(tmp_path))


def _port_params(n=20, d=4, q=2, m=5, dtype=torch.float64):
    y = torch.tensor(np.random.default_rng(0).standard_normal((n, d)), dtype=dtype)
    return tg.init_params(torch.Generator().manual_seed(0), y,
                          tg.GPLVMConfig(q=q, num_inducing=m))


def test_checkpoint_roundtrip(tmp_path):
    params = _port_params()
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, params, meta={"iteration": 7, "bound": -1.5})
    loaded, meta = tckpt.load(path, params)
    assert meta == {"iteration": 7, "bound": -1.5}
    for (name, a), (_, b) in zip(loaded.named_parameters(), params.named_parameters()):
        assert a.dtype == b.dtype and a.device == b.device, name
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(path, _port_params(n=21))


def test_jax_checkpoint_loads_in_the_port(tmp_path, rng):
    y = jnp.asarray(rng.standard_normal((20, 4)))
    jp = jg.init_params(jax.random.key(0), y, jg.GPLVMConfig(q=2, num_inducing=5))
    path = str(tmp_path / "ck.npz")
    jckpt.save(path, jax.tree.map(np.asarray, jp), meta={"iteration": 3})
    loaded, meta = tckpt.load(path, _port_params())
    assert meta == {"iteration": 3}
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (name, a), (path_, b) in zip(loaded.named_parameters(), jleaves):
        assert name.replace(".", "/") == jckpt._path_str(path_)
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    params = _port_params()
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, params, meta={"iteration": 4, "bound": 2.0})
    like = jg.init_params(jax.random.key(1), jnp.asarray(rng.standard_normal((20, 4))),
                          jg.GPLVMConfig(q=2, num_inducing=5))
    loaded, meta = jckpt.load(path, like)
    assert meta == {"iteration": 4, "bound": 2.0}
    with np.load(path) as f:
        assert sorted(f.files) == sorted(
            ["__gparml_meta__"] + [jckpt._path_str(p) for p, _ in
                                   jax.tree_util.tree_flatten_with_path(like)[0]])
    for (_, a), b in zip(params.named_parameters(), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


# --- init, logging, optimizers ----------------------------------------------

def test_host_candidate_rows_match_jax(rng):
    x = rng.standard_normal((20000, 3))
    for m, seed in ((8, 7), (400, 1)):
        a = tinit.host_candidate_rows(x, m=m, seed=seed)
        np.testing.assert_array_equal(a, jinit.host_candidate_rows(x, m=m, seed=seed))
        assert a.shape == (max(16 * m, 4096), 3)
    small = tinit.host_candidate_rows(x[:100], m=8, seed=7)
    np.testing.assert_array_equal(small, x[:100])


def test_make_latents_from_numpy_transposes_on_the_host(rng):
    mu, s = rng.standard_normal((30, 3)), rng.uniform(0.2, 1.0, (30, 3))
    lat = TP.make_latents(mu, s, layout="qn")
    jlat = JP.make_latents(mu, s, layout="qn")
    assert tuple(lat.mu.shape) == (3, 30) and lat.mu.is_contiguous()
    np.testing.assert_array_equal(lat.mu.detach().numpy(), np.asarray(jlat.mu))
    np.testing.assert_allclose(lat.u_s.detach().numpy(), np.asarray(jlat.u_s), rtol=1e-15)
    nq = TP.make_latents(mu, s)
    np.testing.assert_array_equal(nq.mu.detach().numpy(), mu)


@pytest.mark.parametrize("ext", ["jsonl", "csv"])
def test_write_history_files_match_jax(tmp_path, ext):
    hist = {"bound": np.array([-3.0, -2.5, np.nan]), "gnorm2": np.array([1.0, 0.5, np.nan]),
            "accepted": np.array([True, False, False])}
    jpath, tpath = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    jlog.write_history(jpath, hist, extra={"avg_iter_wall_s": 0.25})
    tlog.write_history(tpath, hist, extra={"avg_iter_wall_s": 0.25})
    with open(jpath) as fj, open(tpath) as ft:
        assert fj.read() == ft.read()
    tlog.write_history(str(tmp_path / "b.jsonl"), np.array([1.0, np.nan]))
    assert _history(tmp_path / "b.jsonl") == [{"iteration": 0, "bound": 1.0}]


def test_iteration_timer_and_timer():
    with tlog.iteration_timer() as it:
        for i in (-1, 0, 1):
            tlog.stamp_iteration(i)
    tlog.stamp_iteration(5)   # no live timer: dropped
    assert sorted(it.wall_seconds()) == [0, 1]
    timer = tlog.Timer()
    timer.start("a")
    assert timer.stop("a") >= 0 and set(timer.summary()) == {"a"}


def _fit_problem():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((40, 5))
    jcfg = jg.GPLVMConfig(q=2, num_inducing=6, stats_impl="xla")
    jp = jg.init_params(jax.random.key(0), jnp.asarray(y), jcfg)
    tp = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = tg.GPLVMConfig(q=2, num_inducing=6, stats_impl="xla")
    return y, jcfg, jp, tcfg, tp


@pytest.mark.parametrize("optimizer", ["adam", "gd"])
def test_first_order_fit_matches_jax(optimizer):
    """5 steps of optax.adam / optax.sgd (the JAX fit) against
    torch.optim.Adam / SGD (the port's) from the same params, float64: the
    per-step bound history, the final bound and every leaf."""
    y, jcfg, jp, tcfg, tp = _fit_problem()
    rj = jg.fit(jp, jnp.asarray(y), jcfg, iters=5, optimizer=optimizer, learning_rate=0.05)
    rt = tg.fit(tp, torch.tensor(y), tcfg, iters=5, optimizer=optimizer, learning_rate=0.05)
    np.testing.assert_allclose(rt.history, np.asarray(rj.history), rtol=1e-8)
    np.testing.assert_allclose(rt.bound, float(rj.bound), rtol=1e-8)
    assert rt.n_evals == int(rj.n_evals) == 6 and rt.trace is None
    for a, b in zip(TP.leaves(rt.params), jax.tree.leaves(rj.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)


# --- the CLI ----------------------------------------------------------------

def test_option_strings_match_jax():
    """The same options with the same defaults and choices; the port adds
    --device, which stands in for the JAX package's JAX_PLATFORMS."""
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, tuple(a.choices or ()),
                         a.required, type(a).__name__) for a in parser._actions}
    j, t = surface(jcli.build_parser()), surface(tcli.build_parser())
    assert set(t) - set(j) == {"device"}
    assert {k: v for k, v in t.items() if k != "device"} == j
    assert t["device"][:3] == (("--device",), "cuda", ("cuda", "cpu"))


@pytest.mark.parametrize("extra, item", [(["--fixed-embeddings", "--optimizer", "svgp"],
                                          "item 2: SVGP"),
                                         (["-p", "remote"], "item 3: parallel")])
def test_unported_modes_raise(tmp_path, extra, item):
    """The two modes that raised NotImplementedError before their ROADMAP
    items were ported now run: --fixed-embeddings --optimizer svgp, and -p
    remote, here as one process without a process group."""
    tdata.save_partitioned(str(tmp_path / "in"), np.ones((8, 2)), 1)
    argv = ["-i", str(tmp_path / "in"), "-e", str(tmp_path / "e"), *CPU, *extra]
    if "remote" in extra:
        summary = tcli.main(argv + ["-T", "1", "-q", "1", "-m", "2", "--init", "random"])
        assert summary["parallel"] == "remote" and summary["devices"] == 1
        return
    x = np.linspace(-1.0, 1.0, 8)[:, None]
    tdata.save_embeddings(str(tmp_path / "e"), x, np.zeros_like(x), n_partitions=1)
    summary = tcli.main(argv + ["-T", "3", "-m", "2", "--batch-size", "4"])
    assert summary["mode"] == "svgp" and np.isfinite(summary["final_elbo"])


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    tdata.save_partitioned(str(tmp_path / "in"), np.ones((8, 2)), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-i", str(tmp_path / "in"), "-e", str(tmp_path / "e")])


def test_cli_end_to_end_and_resume(tmp_path):
    """Partitioned inputs -> fit -> embeddings, history, checkpoint and
    summary -> resume with --load keeps (or improves) the bound."""
    y, _ = tdata.synthetic_gplvm(n=48, d=5, q_true=1, seed=1)
    inputs, emb, stats = tmp_path / "inputs", tmp_path / "embeddings", tmp_path / "statistics"
    tdata.save_partitioned(str(inputs), y, 3, prefix="Y")
    argv = ["-i", str(inputs), "-e", str(emb), "-s", str(stats),
            "-T", "15", "-q", "2", "-m", "6", "--seed", "0", *CPU]
    s1 = tcli.main(argv)
    assert np.isfinite(s1["final_bound"]) and s1["devices"] == 1
    assert sorted(p.name for p in emb.iterdir()) == sorted(
        f"X_{k}_{i}.npy" for k in ("mu", "S") for i in range(3))
    lines = _history(stats / "bound_history.jsonl")
    assert lines[-1]["bound"] == pytest.approx(s1["final_bound"], rel=1e-5)
    for row in lines:
        assert {"iteration", "bound", "gnorm2", "lambda", "alpha",
                "accepted", "avg_iter_wall_s"} <= set(row)
        assert isinstance(row["accepted"], bool)
    with open(stats / "summary.json") as f:
        assert json.load(f)["final_bound"] == s1["final_bound"]
    s2 = tcli.main(argv + ["--load"])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-3


def test_cli_adam_and_fixed_beta(tmp_path):
    y, _ = tdata.synthetic_gplvm(n=32, d=4, q_true=1, seed=2)
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    for opt in ("adam", "gd"):
        summary = tcli.main(["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "emb"),
                             "-T", "10", "-q", "2", "-m", "5", "--optimizer", opt,
                             "--fixed-beta", *CPU])
        assert np.isfinite(summary["final_bound"]) and summary["n_evals"] == 11


def test_cli_qn_resume_and_unpadded_checkpoint(tmp_path):
    """--layout qn: (Q, N) latents in the checkpoint, (N, Q) embeddings on
    disk, and a resume that continues from them."""
    y, _ = tdata.synthetic_gplvm(n=43, d=4, q_true=1, seed=5)
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    argv = ["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "emb"),
            "-s", str(tmp_path / "st"), "-T", "8", "-q", "2", "-m", "5",
            "--layout", "qn", *CPU]
    s1 = tcli.main(argv)
    with np.load(tmp_path / "st" / "checkpoint.npz") as f:
        assert f["lat/mu"].shape == (2, 43)
    assert tdata.load_embeddings(str(tmp_path / "emb"))[0].shape == (43, 2)
    s2 = tcli.main(argv + ["--load"])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-3


def test_cli_trace_timing_and_profile(tmp_path):
    y, _ = tdata.synthetic_gplvm(n=40, d=4, q_true=1, seed=3)
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    stats = tmp_path / "statistics"
    summary = tcli.main(["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "emb"),
                         "-s", str(stats), "-T", "8", "-q", "2", "-m", "5",
                         "--trace-timing", "--profile", str(tmp_path / "trace"), *CPU])
    assert np.isfinite(summary["final_bound"])
    lines = _history(stats / "bound_history.jsonl")
    assert lines and all(row["wall_s"] > 0 for row in lines)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "gparml.eval" for e in trace["traceEvents"])


def test_cli_resume_matches_jax(tmp_path):
    """The JAX CLI fits and writes its folders; then --load -T 5 --dtype
    float64 in both CLIs, each in its own copy of those folders, gives the
    same SCG bound at each iteration (the checkpoint sets every leaf)."""
    y, _ = jdata.synthetic_gplvm(n=40, d=4, q_true=1, seed=6)
    jdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    run = tmp_path / "run"
    base = ["-i", str(tmp_path / "inputs"), "-q", "2", "-m", "5", "--dtype", "float64"]
    jcli.main(base + ["-e", str(run / "emb"), "-s", str(run / "st"), "-T", "6"])
    for who in ("jax", "port"):
        shutil.copytree(run, tmp_path / who)
    resume = ["-T", "5", "--load"]
    sj = jcli.main(base + resume + ["-e", str(tmp_path / "jax" / "emb"),
                                    "-s", str(tmp_path / "jax" / "st")])
    st = tcli.main(base + resume + ["-e", str(tmp_path / "port" / "emb"),
                                    "-s", str(tmp_path / "port" / "st"), *CPU])
    hj = _history(tmp_path / "jax" / "st" / "bound_history.jsonl")
    ht = _history(tmp_path / "port" / "st" / "bound_history.jsonl")
    assert len(hj) == len(ht) == 5
    np.testing.assert_allclose([r["bound"] for r in ht], [r["bound"] for r in hj], rtol=1e-8)
    assert [r["accepted"] for r in ht] == [r["accepted"] for r in hj]
    np.testing.assert_allclose(st["final_bound"], sj["final_bound"], rtol=1e-8)
    assert st["n_evals"] == sj["n_evals"]


# --- SVGP mode (tests/test_io_cli.py) ----------------------------------------

def _svgp_folders(tmp_path, rng, n=200):
    x = rng.uniform(-2, 2, (n, 1))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((n, 1))
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    tdata.save_embeddings(str(tmp_path / "emb"), x, np.full_like(x, 1e-6), n_partitions=2)
    return ["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "emb"), "-q", "1",
            "--fixed-embeddings", "--optimizer", "svgp", "--batch-size", "64",
            "--learning-rate", "0.05"]


@pytest.mark.parametrize("layout", ["nq", "qn"])
def test_cli_svgp_mode_and_resume(tmp_path, rng, layout):
    """--fixed-embeddings --optimizer svgp: a fit, then --load restores the
    SVGP parameters and goes on (a cold start of the same length ends
    lower)."""
    argv = _svgp_folders(tmp_path, rng) + ["-m", "8", "--layout", layout, *CPU]
    stats = ["-s", str(tmp_path / "st")]
    s1 = tcli.main(argv + stats + ["-T", "150"])
    assert s1["mode"] == "svgp" and np.isfinite(s1["final_elbo"])
    assert s1["final_elbo_exact"] is True and s1["final_elbo_n"] == 200
    with np.load(tmp_path / "st" / "checkpoint.npz") as f:
        meta = json.loads(bytes(f["__gparml_meta__"].tobytes()).decode())
    assert meta == {"iteration": 150, "bound": s1["final_elbo"]}
    s2 = tcli.main(argv + stats + ["-T", "50", "--load"])
    assert s2["final_elbo"] >= s1["final_elbo"] - 25.0
    s_cold = tcli.main(argv + ["-T", "50", "-s", str(tmp_path / "st2")])
    assert s2["final_elbo"] > s_cold["final_elbo"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_svgp_checkpoint_resumes_across_packages(tmp_path, rng, writer):
    """One package fits and writes checkpoint.npz; then --load -T 0 in both
    CLIs, float64, evaluates the exact ELBO of the loaded parameters: the
    same value (the rows summed in other orders)."""
    argv = _svgp_folders(tmp_path, rng, n=120) + ["-m", "6", "--dtype", "float64"]
    run = tmp_path / "run"
    first = jcli.main if writer == "jax" else (lambda a: tcli.main(a + CPU))
    first(argv + ["-s", str(run), "-T", "40"])
    for who in ("jax", "port"):
        shutil.copytree(run, tmp_path / who)
    sj = jcli.main(argv + ["-s", str(tmp_path / "jax"), "-T", "0", "--load"])
    st = tcli.main(argv + ["-s", str(tmp_path / "port"), "-T", "0", "--load", *CPU])
    assert st["final_elbo_exact"] is sj["final_elbo_exact"] is True
    np.testing.assert_allclose(st["final_elbo"], sj["final_elbo"], rtol=1e-10)