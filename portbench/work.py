"""Operations and bytes of the work, counted from shapes.

``psi_work`` and its helpers are frozen copies of ``chip_smoke.py``'s
``_work``, ``_psi1_pair`` and ``_psi1_elems``: the float32 operations and
bytes that one forward ('fwd') or backward ('bwd') Psi-statistics call
needs, whatever implements it. ``bound_ops`` counts the bound's M x M
algebra. Neither depends on the program.
"""

from __future__ import annotations


def psi1_pair(kind, q, d):
    """Psi1's work a (row, inducing point) pair of a forward ('fwd') or
    backward ('bwd') call: (float32 operations of the direct form, an expf
    as one and an FMA as two; K of the TF32 products of the tensor-core
    form; float32 operations left beside those products)."""
    if kind == "fwd":
        return 4 * q + 4 + 2 * d, 2 * q + d, 2
    return 10 * q + 6 + 4 * d, 2 * q + 2 * d + 4 * q, 4


def psi1_elems(kind, n, m, q, d):
    """Elements Psi1's part of a call must move: each input read once (mu,
    s, Y, w, Z, alpha, sf2; the backward also dPsi1Y) and each output
    written once (the forward Psi1^T (w Y); the backward dmu, ds, dY, dZ,
    dalpha and dsf2)."""
    inputs = n * (2 * q + d + 1) + m * q + q + 1
    if kind == "fwd":
        return inputs + m * d
    return inputs + m * d + n * (2 * q + d) + m * q + q + 1


def psi_work(kind, n, m, q, d):
    """(float32 operations, bytes) of one forward ('fwd') or backward ('bwd')
    Psi-statistics call: the operations per (row, cell) and per (row,
    inducing point) pair, each computed once (an expf as one operation, an
    FMA as two), and each input read and each output written once."""
    cells = m * (m + 1) // 2
    ops1 = psi1_pair(kind, q, d)[0]
    if kind == "fwd":
        # Psi2: per q a difference, a product, an FMA; then two adds, the
        # exp and the weighted FMA: 4Q + 5. Out: Psi2 beside Psi1^T (w Y).
        ops = n * (cells * (4 * q + 5) + m * ops1)
        elems = psi1_elems(kind, n, m, q, d) + m * m
    else:
        # Psi2: the exponent once, 4Q + 4 (as in the forward, times w);
        # g = K w e and G += g, 2; t_q += g d_q, u_q += g d_q^2, 4Q; the
        # centred cell sum A_q += w e (c_q d_q), one FMA on the exponent's
        # product, 2Q: 10Q + 6. In: also Psi1^T (w Y), Psi2 and dPsi2.
        ops = n * (cells * (10 * q + 6) + m * ops1)
        elems = psi1_elems(kind, n, m, q, d) + m * d + 2 * m * m
    return ops, 4 * elems


def bound_ops(m, q, d):
    """Float operations of the bound's M x M algebra in one evaluation with
    its gradient: K_MM (M^2 Q pairs, 3 operations each, and M^2 exps), the
    Cholesky factors of K_MM, Psi2 and B (M^3 / 3 each), W = Lm^-1 Lp (M^3),
    W W^T (M^3, symmetric), the two solves of Psi1^T Y (2 M^2 D); the
    gradient counted as twice the forward."""
    forward = 3 * m * m * q + m * m + 3 * (m ** 3 // 3) + 2 * m ** 3 + 2 * m * m * d
    return 3 * forward


def eval_ops(n, m, q, d):
    """Operations of one bound + gradient evaluation: the Psi forward and
    backward calls and the bound's algebra."""
    return psi_work("fwd", n, m, q, d)[0] + psi_work("bwd", n, m, q, d)[0] + bound_ops(m, q, d)
