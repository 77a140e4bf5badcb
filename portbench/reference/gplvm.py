"""Plain PyTorch reference of the Bayesian-GPLVM bound and its gradient.

Titsias & Lawrence (2010), ARD-RBF kernel, variational q(x_n) =
N(mu_n, diag(s_n)), positive parameters through exp. The bound is

  F = -(ND/2) log 2pi + (ND/2) log beta - (D/2) log|B| - (beta/2) sum y^2
      - (beta D/2) psi0 + (beta D/2) tr(K_MM^-1 Psi2)
      + (beta^2/2) |LB^-1 Lm^-1 Psi1^T Y|^2 - KL(q(X) || N(0, I)),

B = I + beta Lm^-1 Psi2 Lm^-T, Lm the Cholesky factor of K_MM plus a jitter;
a float32 model regularizes Psi2 as its float32 form must (``bound``).
Nothing here comes from the program under test: it is written from the
formulas, in blocks of rows, in any dtype (float64 for the reference;
float32 with TF32 products for the control).

The Psi statistics are taken in expanded form, so that their N M^2 Q work
runs as matrix products: with c = alpha / (2 alpha s + 1) and
zb = (z_m + z_k) / 2 for the cell (m, k), m <= k,

  log Psi2_n[m, k] = [a_n, 1, c_n, c_n mu_n] . [1, E0_mk, -zb^2, 2 zb]
  a_n = 2 log sf2 - 1/2 sum_q log(2 alpha s_nq + 1) - sum_q c_nq mu_nq^2
  E0_mk = -1/4 sum_q alpha_q (z_mq - z_kq)^2,

and likewise log Psi1_n[m] = [a1_n, c1_n, c1_n mu_n] . [1, -z_m^2 / 2, z_m]
with c1 = alpha / (alpha s + 1). The gradient runs in two sweeps over the
rows: the first sums the statistics, autograd takes the bound's cotangents
(M x M, M x D), and the second carries them back through each block's
exponent by hand (two products a block) and through the row features by
autograd. In float64 the expanded exponent keeps ~1e-14 of its terms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# elements of one block's (rows, cells) exponent
_BLOCK_ELEMS = 1 << 28


class Globals(NamedTuple):
    """Unconstrained global leaves, in the program's leaf order."""
    z: torch.Tensor        # (M, Q)
    u_sf2: torch.Tensor    # ()
    u_alpha: torch.Tensor  # (Q,)
    u_beta: torch.Tensor   # ()


class Stats(NamedTuple):
    psi0: torch.Tensor     # ()
    psi1_y: torch.Tensor   # (M, D)
    cells: torch.Tensor    # (C,) sum_n Psi2_n over the cells m <= k
    yy: torch.Tensor       # ()
    kl: torch.Tensor       # ()
    n: float

    def __add__(self, o):
        return Stats(*(a + b for a, b in zip(self[:5], o[:5])), self.n + o.n)


def cells_of(m: int, device):
    return torch.triu_indices(m, m, device=device)


def _w2(z, alpha, cells):
    zm, zk = z[cells[0]], z[cells[1]]
    zb = 0.5 * (zm + zk)
    e0 = -0.25 * torch.sum(alpha * (zm - zk) ** 2, dim=1)
    one = torch.ones_like(e0)
    return torch.cat([one[:, None], e0[:, None], -zb * zb, 2.0 * zb], dim=1)


def _x2(mu, s, sf2, alpha):
    den = 2.0 * alpha * s + 1.0
    c = alpha / den
    a = 2.0 * torch.log(sf2) - 0.5 * torch.sum(torch.log(den), 1) - torch.sum(c * mu * mu, 1)
    return torch.cat([a[:, None], torch.ones_like(a)[:, None], c, c * mu], dim=1)


def _w1(z):
    return torch.cat([torch.ones_like(z[:, :1]), -0.5 * z * z, z], dim=1)


def _x1(mu, s, sf2, alpha):
    den = alpha * s + 1.0
    c = alpha / den
    a = torch.log(sf2) - 0.5 * torch.sum(torch.log(den), 1) - 0.5 * torch.sum(c * mu * mu, 1)
    return torch.cat([a[:, None], c, c * mu], dim=1)


def _block_rows(n: int, ncells: int) -> int:
    return max(1, min(n, _BLOCK_ELEMS // max(ncells, 1)))


def constrain(g: Globals):
    return g.z, torch.exp(g.u_sf2), torch.exp(g.u_alpha), torch.exp(g.u_beta)


@torch.no_grad()
def stats(y, mu, u_s, g: Globals, cells) -> Stats:
    """The summed statistics of rows y (N, D), mu and u_s (N, Q)."""
    z, sf2, alpha, _ = constrain(g)
    n, d = y.shape
    w1, w2 = _w1(z), _w2(z, alpha, cells)
    psi1_y = torch.zeros((z.shape[0], d), dtype=y.dtype, device=y.device)
    acc = torch.zeros(cells.shape[1], dtype=y.dtype, device=y.device)
    kl = torch.zeros((), dtype=y.dtype, device=y.device)
    b = _block_rows(n, cells.shape[1])
    for i in range(0, n, b):
        mu_b, s_b, y_b = mu[i:i + b], torch.exp(u_s[i:i + b]), y[i:i + b]
        p1 = torch.exp(_x1(mu_b, s_b, sf2, alpha) @ w1.T)
        psi1_y += p1.T @ y_b
        p2 = torch.exp_(_x2(mu_b, s_b, sf2, alpha) @ w2.T)
        acc += p2.sum(0)
        kl += 0.5 * torch.sum(mu_b * mu_b + s_b - torch.log(s_b) - 1.0)
    return Stats(n * sf2, psi1_y, acc, torch.sum(y * y), kl, float(n))


def kmm(z, sf2, alpha, jitter):
    d2 = torch.sum(alpha * (z[:, None, :] - z[None, :, :]) ** 2, dim=-1)
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    return sf2 * torch.exp(-0.5 * d2) + (jitter * sf2) * eye


def _chol(a):
    lo, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, lo, torch.full_like(lo, float("nan")))


def _solve(lo, b):
    return torch.linalg.solve_triangular(lo, b, upper=False)


def _psi2_full(cells_sum, cells, m):
    full = torch.zeros((m, m), dtype=cells_sum.dtype, device=cells_sum.device)
    full = full.index_put((cells[0], cells[1]), cells_sum)
    return full + torch.triu(full, 1).T


def bound(st: Stats, g: Globals, cells, d: int, jitter: float, psi2_eps=None, psi0=None):
    """F from the statistics (differentiable in both).

    ``psi2_eps`` None is the float64 model, the B-form. A float32 model
    (``psi2_eps`` = float32's epsilon) is the bound of the regularized
    Psi2 + 30 eps tr(Psi2) I (3000 eps where the float32 Cholesky factor of
    the first fails), formed as B = I + beta W W^T, W = Lm^-1 chol(.), with
    the trace and the quadratic term clamped at their exact upper limits:
    positive definite by construction, as a float32 bound must be. It is
    computed in the tensors' own dtype (float64 for the reference)."""
    z, sf2, alpha, beta = constrain(g)
    dtype = z.dtype
    m = z.shape[0]
    psi0 = st.n * sf2 if psi0 is None else psi0
    psi2 = _psi2_full(st.cells, cells, m)
    lm = _chol(kmm(z, sf2, alpha, jitter))
    eye = torch.eye(m, dtype=dtype, device=z.device)
    if psi2_eps is None:
        c2 = _solve(lm, _solve(lm, psi2).T)
        lb = _chol(eye + beta * 0.5 * (c2 + c2.T))
        tr = torch.trace(c2)
    else:
        with torch.no_grad():
            probe = (psi2 + 30.0 * psi2_eps * torch.trace(psi2) * eye).float()
            ok = torch.linalg.cholesky_ex(probe)[1] == 0
        scale = 30.0 if bool(ok) else 3000.0
        w = _solve(lm, _chol(psi2 + scale * psi2_eps * torch.trace(psi2) * eye))
        lb = _chol(eye + beta * (w @ w.T))
        tr = torch.minimum(torch.sum(w * w), psi0)
    log_det_b = 2.0 * torch.sum(torch.log(torch.diagonal(lb)))
    cb = _solve(lb, _solve(lm, st.psi1_y))
    quad = torch.sum(cb * cb)
    if psi2_eps is not None:
        quad = torch.minimum(quad, st.yy / beta)
    nd = st.n * d
    return (-nd * _HALF_LOG_2PI + 0.5 * nd * torch.log(beta) - 0.5 * d * log_det_b
            - 0.5 * beta * st.yy - 0.5 * beta * d * psi0 + 0.5 * beta * d * tr
            + 0.5 * beta * beta * quad - st.kl)


def _cotangents(st: Stats, g: Globals, cells, d, jitter, psi2_eps, glob_grad: bool):
    """(F, dF/dcells, dF/dPsi1^T Y, dF/d global leaves or None): the bound's
    autograd on the summed statistics; psi0 = N sf2 enters through u_sf2."""
    leaves = [t.detach().requires_grad_(glob_grad) for t in g]
    gl = Globals(*leaves)
    cs = st.cells.detach().requires_grad_()
    p1y = st.psi1_y.detach().requires_grad_()
    st_ = Stats(None, p1y, cs, st.yy.detach(), st.kl.detach(), st.n)
    with torch.enable_grad():
        f = bound(st_, gl, cells, d, jitter, psi2_eps, psi0=st.n * torch.exp(gl.u_sf2))
        wrt = [cs, p1y] + (leaves if glob_grad else [])
        grads = torch.autograd.grad(f, wrt)
    return f.detach(), grads[0], grads[1], (list(grads[2:]) if glob_grad else None)


def _latent_sweep(y, mu, u_s, g: Globals, cells, gc, gp1y, glob_grad: bool):
    """dF/dmu, dF/du_s (N, Q) of the Psi terms and the KL, and, with
    ``glob_grad``, the Psi terms' part of dF/d(z, u_sf2, u_alpha)."""
    n = y.shape[0]
    z0 = g.z.detach().requires_grad_(glob_grad)
    u_sf2 = g.u_sf2.detach().requires_grad_(glob_grad)
    u_alpha = g.u_alpha.detach().requires_grad_(glob_grad)
    with torch.no_grad():
        sf2c, alphac = torch.exp(u_sf2), torch.exp(u_alpha)
        w1, w2 = _w1(z0), _w2(z0, alphac, cells)
        gw2 = gc[:, None] * w2
    acc_w1 = torch.zeros_like(w1)
    acc_w2 = torch.zeros_like(w2)
    dmu, dus = torch.empty_like(mu), torch.empty_like(u_s)
    b = _block_rows(n, cells.shape[1])
    for i in range(0, n, b):
        mu_b = mu[i:i + b].detach().requires_grad_()
        us_b = u_s[i:i + b].detach().requires_grad_()
        with torch.enable_grad():
            s_b = torch.exp(us_b)
            sf2, alpha = torch.exp(u_sf2), torch.exp(u_alpha)
            x1 = _x1(mu_b, s_b, sf2, alpha)
            x2 = _x2(mu_b, s_b, sf2, alpha)
        with torch.no_grad():
            x1d, x2d = x1.detach(), x2.detach()
            p1 = torch.exp(x1d @ w1.T)
            e1 = (y[i:i + b] @ gp1y.T) * p1
            g1 = e1 @ w1
            acc_w1 += e1.T @ x1d
            p2 = torch.exp_(x2d @ w2.T)
            g2 = p2 @ gw2
            acc_w2 += p2.T @ x2d
            del p2
        torch.autograd.backward([x1, x2], [g1, g2])
        with torch.no_grad():
            s_d = s_b.detach()
            dmu[i:i + b] = mu_b.grad - mu_b.detach()          # KL: d/dmu = mu
            dus[i:i + b] = us_b.grad - 0.5 * (s_d - 1.0)      # KL: d/du_s = (s - 1)/2
    if not glob_grad:
        return dmu, dus, None
    with torch.enable_grad():
        alpha = torch.exp(u_alpha)
        torch.autograd.backward([_w1(z0), _w2(z0, alpha, cells)],
                                [acc_w1, gc[:, None] * acc_w2])
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in (z0, u_sf2, u_alpha)]
    return dmu, dus, grads


def value(y, mu, u_s, g: Globals, d: int, jitter: float, psi2_eps=None) -> float:
    """F at (mu, u_s, g), rows y."""
    cells = cells_of(g.z.shape[0], y.device)
    return float(bound(stats(y, mu, u_s, g, cells), g, cells, d, jitter, psi2_eps))


def value_and_grad(y, mu, u_s, g: Globals, d: int, jitter: float, psi2_eps=None):
    """(-F, gradient of -F) in the leaf order z, u_sf2, u_alpha, u_beta, mu,
    u_s (the latents (N, Q))."""
    cells = cells_of(g.z.shape[0], y.device)
    st = stats(y, mu, u_s, g, cells)
    f, gc, gp1y, gglob = _cotangents(st, g, cells, d, jitter, psi2_eps, True)
    dmu, dus, gpsi = _latent_sweep(y, mu, u_s, g, cells, gc, gp1y, True)
    glob = [gglob[0] + gpsi[0], gglob[1] + gpsi[1], gglob[2] + gpsi[2], gglob[3]]
    return -float(f), [-t for t in glob] + [-dmu, -dus]


class InferObjective:
    """-F of the training rows' summed statistics ``train`` plus those of new
    rows y_new with latents (mu*, u_s*), every trained parameter held: the
    objective of latent inference, and its gradient in (mu*, u_s*)."""

    def __init__(self, train: Stats, g: Globals, y_new, d: int, jitter: float, psi2_eps=None):
        self.train, self.g, self.y_new, self.d, self.jitter = train, g, y_new, d, jitter
        self.psi2_eps = psi2_eps
        self.cells = cells_of(g.z.shape[0], y_new.device)

    def __call__(self, leaves):
        mu_new, us_new = leaves
        st = self.train + stats(self.y_new, mu_new, us_new, self.g, self.cells)
        f, gc, gp1y, _ = _cotangents(st, self.g, self.cells, self.d, self.jitter, self.psi2_eps,
                                     False)
        dmu, dus, _ = _latent_sweep(self.y_new, mu_new, us_new, self.g, self.cells, gc, gp1y,
                                    False)
        return -float(f), [-dmu, -dus]

    def start(self, y_train, mu_train, s0: float):
        """[mu*, u_s*] of the nearest-neighbour start: each new row takes the
        latent mean of its nearest training row in data space, and s0."""
        mu0 = mu_train[nearest_rows(self.y_new, y_train)]
        return [mu0, torch.full_like(mu0, math.log(s0))]


def nearest_rows(y_new, y_train, piece: int = 1 << 26) -> torch.Tensor:
    """Index of the nearest training row (squared distance) of each new row,
    over pieces of the training rows."""
    step = max(1, piece // max(1, y_new.shape[0]))
    best = idx = None
    yn2 = torch.sum(y_new * y_new, 1)[:, None]
    for i in range(0, y_train.shape[0], step):
        part = y_train[i:i + step]
        d2 = yn2 - 2.0 * (y_new @ part.T) + torch.sum(part * part, 1)[None, :]
        val, arg = torch.min(d2, 1)
        if best is None:
            best, idx = val, arg
        else:
            closer = val < best
            best, idx = torch.where(closer, val, best), torch.where(closer, arg + i, idx)
    return idx


def psi2_eps_of(dtype: torch.dtype):
    """The float32 model's Psi2 regularization scale (``bound``), None for a
    float64 model."""
    return None if dtype == torch.float64 else float(torch.finfo(dtype).eps)


def effective_jitter(jitter: float, dtype: torch.dtype) -> float:
    """The K_MM jitter of the model at the configuration's dtype: the stated
    relative jitter, floored at 100 epsilons of that dtype (a float32
    Cholesky needs it); the reference computes the same model in float64."""
    return max(float(jitter), 100.0 * float(torch.finfo(dtype).eps))


def to_rows(t: torch.Tensor, layout: str, dtype) -> torch.Tensor:
    """(N, Q) rows in ``dtype`` from a latent leaf stored nq (N, Q) or qn (Q, N)."""
    t = t.detach()
    return (t.T if layout == "qn" else t).to(dtype).contiguous()


def rows_of_y(y: torch.Tensor, y_layout: str, dtype) -> torch.Tensor:
    y = y.detach()
    return (y.T if y_layout == "dn" else y).to(dtype).contiguous()


def globals_of(leaves, dtype) -> Globals:
    return Globals(*(t.detach().to(dtype) for t in leaves[:4]))


def leaf_gaps(got, ref, floor_share: float = 1e-3) -> float:
    """Worst-leaf gap of norms: max over leaves of | |got_i| - |ref_i| | /
    max(|ref_i|, median_j |ref_j|), over the leaves whose reference norm is
    at least ``floor_share`` of the median leaf's (the others are nought to
    rounding)."""
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(norms)[len(norms) // 2]
    return max(abs(float(torch.linalg.vector_norm(a.double())) - r) / max(r, med)
               for a, r in zip(got, norms) if r >= floor_share * med)


def rel_gap(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), 1e-300)


def set_precision(control: bool) -> None:
    """float64 (or float32 without TF32) for the reference; TF32 products
    for the control."""
    torch.backends.cuda.matmul.allow_tf32 = bool(control)
    torch.backends.cudnn.allow_tf32 = bool(control)
