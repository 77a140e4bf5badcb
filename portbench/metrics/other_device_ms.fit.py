"""other_device_ms.fit (ms): device time an evaluation spends in kernels
outside the program's ``gparml::`` namespace: the bound's algebra on cuBLAS
and cuSOLVER, autograd's and the optimizer's elementwise kernels."""


def read(r):
    evals = r.counters.get("evals")
    if not evals:
        return None
    return 1e3 * r.trace.seconds_where(lambda name: "gparml::" not in name) / evals
