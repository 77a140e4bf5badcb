"""One rank of the data-parallel checks of tests/test_torch_fit_dp.py (NOT a
test module).

    python tests/torch_dp_worker.py MODE OUT_DIR

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set, one process per
rank, on the CPU over gloo, each rank holding its contiguous block of a
float64 problem of N=64, M=8, Q=3, D=5 made from a seed (``problem``).
MODE ``reference`` writes OUT_DIR/rank<r>.npz: the program's bound and
gradient under the process group's mesh and a 2-iteration SCG call's
change, beside the reference summed over the ranks
(``portbench/reference/gplvm_dp.py``) at the same points. MODE ``spans``
writes OUT_DIR/rank<r>.json: the ``gparml.allreduce.*`` spans a profiled
one-iteration fit records, the reductions ``LeafReduce`` made, and the
bytes the mesh counts for one sum of the statistics and one evaluation;
then a fit with no profiler, in which entering a span raises.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

N, D, Q, M = 64, 5, 3, 8
ITERS = 2


def problem():
    """(Y, GPLVM parameter arrays) from seed 5: every leaf away from a start."""
    from gparml_tpu_torch.models import params as P

    rng = np.random.default_rng(5)
    y = rng.standard_normal((N, D))
    mu = rng.standard_normal((N, Q))
    u_s = np.log(rng.uniform(0.2, 1.5, (N, Q)))
    glob = P.GlobalArrays(rng.standard_normal((M, Q)), np.log(1.3),
                          np.log(rng.uniform(0.3, 2.0, Q)), np.log(2.1))
    return y, P.GPLVMArrays(glob, P.LatentArrays(mu, u_s))


def _rank_model():
    """(mesh, this rank's rows of Y, its parameters, config, (start, stop))."""
    import torch

    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(device_type="cpu")
    mesh = distributed.global_mesh("cpu")
    y, arrays = problem()
    start, stop, _ = distributed.process_row_range(N)
    t = lambda a: torch.tensor(np.ascontiguousarray(a[start:stop]))
    glob = P.global_from_numpy(arrays.glob, device="cpu", dtype=torch.float64)
    p = P.GPLVMParams(glob, P.LatentParams(t(arrays.lat.mu), t(arrays.lat.u_s)))
    return mesh, t(y), p, gplvm.GPLVMConfig(q=Q, num_inducing=M), (start, stop)


def reference(out_dir):
    import torch

    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.parallel import distributed
    from portbench.reference import gplvm as ref
    from portbench.reference import gplvm_dp as ref_dp

    mesh, y, p, cfg, rows = _rank_model()
    f, grads = gplvm.neg_bound_value_and_grad(p, y, cfg, mesh=mesh)
    x1 = P.leaves(p)
    jitter = ref.effective_jitter(cfg.jitter, torch.float64)

    def vg(x):
        return ref_dp.value_and_grad(y, x[4], x[5], ref.Globals(*x[:4]), D, jitter)

    f_ref, g_ref = vg(x1)
    res = gplvm.fit(p, y, cfg, iters=ITERS, mesh=mesh)
    ran = np.isfinite(res.trace["alpha"])
    x2 = P.leaves(res.params)
    x2_ref = ref_dp.replay(vg, x1, res.trace["alpha"][ran].tolist(),
                           res.trace["accepted"][ran].tolist(), g0=g_ref)
    out = {"f": float(f), "f_ref": f_ref, "bound": float(res.bound),
           "bound_ref": ref_dp.value(y, x2[4], x2[5], ref.Globals(*x2[:4]), D, jitter),
           "rows": np.array(rows)}
    for i in range(6):
        out[f"grad_{i}"] = grads[i].numpy()
        out[f"grad_ref_{i}"] = g_ref[i].numpy()
        out[f"change_{i}"] = (x2[i] - x1[i]).numpy()
        out[f"change_ref_{i}"] = (x2_ref[i] - x1[i]).numpy()
    np.savez(os.path.join(out_dir, f"rank{distributed.process_index()}.npz"), **out)
    distributed.shutdown()


def spans(out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gparml_tpu_torch.models import gplvm
    from gparml_tpu_torch.parallel import distributed
    from gparml_tpu_torch.utils import logging as glog

    mesh, y, p, cfg, _ = _rank_model()
    reductions = []
    for name in ("_sum", "max_abs"):
        orig = getattr(distributed.LeafReduce, name)

        def counted(self, *args, _orig=orig, **kw):
            reductions.append(1)
            return _orig(self, *args, **kw)

        setattr(distributed.LeafReduce, name, counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = gplvm.fit(p, y, cfg, iters=1, mesh=mesh)
    n_reductions = len(reductions)
    events = [e for e in prof.events() if e.name.startswith("gparml.")]
    (call,) = [e for e in events if e.name == "gparml.fit"]
    found = [{"name": e.name, "parent": e.cpu_parent.name if e.cpu_parent else None,
              "same_thread": e.thread == call.thread}
             for e in events if e.name.startswith("gparml.allreduce.")]
    # bytes: one sum of the statistics alone, then one evaluation
    st = gplvm._stats(p, y, cfg, mesh=mesh, across_processes=False)
    mesh.allreduce_bytes = 0
    distributed.all_reduce_stats(st, mesh)
    stats_bytes = mesh.allreduce_bytes
    gplvm.neg_bound_value_and_grad(p, y, cfg, mesh=mesh)
    eval_bytes = mesh.allreduce_bytes - stats_bytes

    # no profiler: no span is entered
    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler recording")

    glog._RecordFunctionFast = refuse
    gplvm.fit(p, y, cfg, iters=1, mesh=mesh)
    out = {"spans": found, "reductions": n_reductions, "n_evals": int(res.n_evals),
           "stats_bytes": stats_bytes, "eval_bytes": eval_bytes,
           "element_size": torch.finfo(y.dtype).bits // 8}
    with open(os.path.join(out_dir, f"rank{distributed.process_index()}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


if __name__ == "__main__":
    {"reference": reference, "spans": spans}[sys.argv[1]](sys.argv[2])
