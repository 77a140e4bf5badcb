"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

from __future__ import annotations

import time

import torch

from portbench import harness

TINY = {"n": 1200, "q": 3, "m": 12, "d": 5}
TINY_MIX = {"infer": {"batch": 40, "pool_batches": 12, "iters": 6, "check_calls": 3}}


def cell(name: str, dtype: str = "float64") -> harness.Cell:
    c = harness.Cell(name)
    c.config = dict(c.config, dtype=dtype, **TINY)
    c.mix = dict(c.mix, **TINY_MIX.get(c.mix["drive"], {}))
    return c


def run(c: harness.Cell, seed: int = 3_000_000_123, seconds: float = 0.3,
        traced: bool = False) -> dict:
    """A run of the cell on the CPU, past the harness's look for a card."""
    return harness.run_cell(c, seed, seconds, traced, [torch.device("cpu")],
                            time.perf_counter(), "cpu")
