"""device_idle.fit_dp (%): the share of the traced window in which no
operation (kernel, copy or set) runs on rank 0's card. The harness finds a
metric's reader by the metric's name, so each cell kind's metric has a
file of its own."""


def read(r):
    w = r.trace.window_s
    return None if w <= 0 else 100.0 * (1.0 - r.trace.busy_s() / w)
