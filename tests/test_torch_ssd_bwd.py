"""The algebra of the SSD scan's chunk-parallel backward, on the CPU.

On the card, bf16 inputs run the backward of ``csrc/ssd_scan.cu`` as three
kernels: (a) per chunk, its decays and two state terms
U_c = sum_s exp(g_Q - g_s) dt_s x_s B_s^T and V_c = sum_t exp(g_t) dy_t C_t^T;
(b) per state entry, a forward pass that turns U into the chunk-start
states S_c and a reverse pass that turns V into dS_c, the gradient of
chunk c's end state; (c) per chunk, the gradients from S_c and dS_c, with
one da partial per (batch, head, chunk).  ``chunk_parallel_bwd`` below is a
plain mirror of those three phases, written from the formulas at the top of
``csrc/ssd_scan.cu``; it is not part of the package.  It proves the
bookkeeping that the chunk split adds (dS indexing across chunk boundaries,
the sum of dS * S at a chunk's last step, the ragged tail, the da partials)
before the kernels run on the card.

Held against ``torch.autograd`` of ``kernels/ref.py::ssd_scan_ref`` in
float64 to 1e-10 of each gradient's largest magnitude (the same function,
summed in another order), and against ``jax.grad`` of the JAX package's
``models/ssm.py::ssd_chunked`` in fp32 to 1e-5 (fp32 sums in another
order, as ``tests/test_torch_ssm.py`` holds the plain version), or no
further from it than twice JAX's own distance from the float64 mirror: dA
is a sum over every position of differences of sums, and in one case here
every fp32 version of it, JAX's and the port's plain version included, is
5e-5 to 8e-5 from float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ref import ssd_scan_ref

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dA", "dB", "dC")


def chunked(S, chunk):
    """(Q, nc, chunks): the chunk length, the number of chunks, and a
    function that zero-pads the tail of a (B,S,...) tensor (dt = 0 there)
    and cuts it into (B, nc, Q, ...)."""
    Q = min(chunk, S)
    nc = -(-S // Q)

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                    + (0, nc * Q - S))
        return t.reshape(t.shape[0], nc, Q, *t.shape[2:])

    return Q, nc, chunks


def chunk_decays(dtc, A):
    """Phase (a)'s decays of (B,nc,Q,H) chunked dt: g (the cumsum of dt a
    inside each chunk), exp(g), exp(g_Q - g), w = exp(g_Q - g) dt and the
    chunk decay exp(g_Q) (B,nc,H)."""
    g = torch.cumsum(dtc * A, dim=2)
    dec = torch.exp(g[:, :, -1:] - g)
    return g, torch.exp(g), dec, dec * dtc, torch.exp(g[:, :, -1])


def chunk_state_u(w, xc, Bc):
    """Phase (a)'s U_c = sum_s w_s x_s B_s^T, (B,nc,H,P,N)."""
    return torch.einsum("bcsh,bcshp,bcshn->bchpn", w, xc, Bc)


def pass_states(U, decay):
    """Phase (b)'s forward pass, in place: U_c -> S_c, the state at chunk
    c's start (S_0 = 0, S_{c+1} = exp(g_Q,c) S_c + U_c)."""
    state = torch.zeros_like(U[:, 0])
    for c in range(U.shape[1]):
        u_c = U[:, c].clone()
        U[:, c] = state
        state = decay[:, c, :, None, None] * state + u_c
    return U


def chunk_parallel_bwd(x, dt, A, Bm, Cm, dy, chunk):
    """(dx, ddt, dA, dB, dC) of sum(ssd_scan(x, dt, A, Bm, Cm) * dy) in the
    dtype of x, by the three phases of the card's bf16 backward.  Bm/Cm are
    (B,S,G,N), G dividing H."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    Q, nc, chunks = chunked(S, chunk)

    xc, dyc, dtc = chunks(x), chunks(dy), chunks(dt)
    Bc = chunks(Bm.repeat_interleave(H // G, dim=2))
    Cc = chunks(Cm.repeat_interleave(H // G, dim=2))

    # (a) per chunk: decays, U and V
    g, e, dec, w, decay = chunk_decays(dtc, A)            # (B,nc,Q,H)
    U = chunk_state_u(w, xc, Bc)
    V = torch.einsum("bcth,bcthp,bcthn->bchpn", e, dyc, Cc)

    # (b) per entry: U -> chunk-start states, V -> end-state gradients
    pass_states(U, decay)
    dstate = torch.zeros_like(V[:, 0])
    for c in reversed(range(nc)):
        v_c = V[:, c].clone()
        V[:, c] = dstate
        dstate = decay[:, c, :, None, None] * dstate + v_c
    Sst, dS = U, V

    # (c) per chunk: the gradients
    iq = torch.arange(Q)
    on_or_below = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    below = (iq[:, None] > iq[None, :])[None, None, :, :, None]
    delta = g[:, :, :, None, :] - g[:, :, None, :, :]     # (B,nc,t,s,H)
    L = torch.exp(torch.where(on_or_below, delta,
                              torch.full_like(delta, -torch.inf)))
    dts = dtc[:, :, None, :, :]                           # dt_s
    Gm = torch.einsum("bcthn,bcshn->bctsh", Cc, Bc)       # C_t . B_s
    Dm = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)      # dy_t . x_s
    M, W, Z = Gm * L * dts, L * dts * Dm, Gm * L * Dm
    dSB = torch.einsum("bchpn,bcshn->bcshp", dS, Bc)      # dS B_s
    dx = torch.einsum("bctsh,bcthp->bcshp", M, dyc) + w[..., None] * dSB
    u = (xc * dSB).sum(-1)
    dBh = (torch.einsum("bctsh,bcthn->bcshn", W, Cc)
           + w[..., None] * torch.einsum("bchpn,bcshp->bcshn", dS, xc))
    SD = torch.einsum("bchpn,bcthp->bcthn", Sst, dyc)     # S^T dy_t
    dCh = torch.einsum("bctsh,bcshn->bcthn", W, Bc) + e[..., None] * SD
    v = e * (Cc * SD).sum(-1)
    rowz = (Z * below * dts).sum(3)                       # sum_{s<t}
    colz = (Z * below).sum(2)                             # sum_{t>s}
    diag = torch.diagonal(Z, dim1=2, dim2=3).movedim(-1, 2)
    dg = rowz - colz * dtc + v
    dg[:, :, -1] += e[:, :, -1] * (dS * Sst).sum((-2, -1))
    wu = w * u
    sdda = (torch.cumsum(wu, dim=2) - wu
            + torch.flip(torch.cumsum(torch.flip(dg, [2]), dim=2), [2]))
    da_part = (dtc * sdda).sum(2)                         # (B,nc,H)
    ddt = A * sdda + colz + diag + dec * u

    def unchunk(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]

    def to_groups(t):
        return unchunk(t).reshape(Bsz, S, G, H // G, N).sum(3)

    dA = da_part.sum((0, 1))        # the wrapper's fixed-order sum
    return (unchunk(dx), unchunk(ddt), dA, to_groups(dBh), to_groups(dCh))


def _inputs(rng, B, S, H, P, N, G):
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H)))
    Bm = 0.5 * rng.standard_normal((B, S, G, N))
    Cm = 0.5 * rng.standard_normal((B, S, G, N))
    dy = rng.standard_normal((B, S, H, P))
    return x, dt, A, Bm, Cm, dy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# (B, S, H, P, N, chunk, G): the cases of tests/test_torch_ssm.py (one
# group per head), a ragged tail over 8 chunks, and 2 groups of 2 heads
CASES = [(2, 32, 3, 8, 4, 8, 3), (2, 29, 3, 8, 4, 8, 3),
         (1, 5, 2, 4, 3, 8, 2), (1, 48, 2, 16, 16, 16, 2),
         (2, 61, 3, 8, 4, 8, 3), (2, 45, 4, 8, 6, 8, 2)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", CASES)
def test_chunk_parallel_bwd_matches_autograd_float64(B, S, H, P, N, chunk,
                                                     G):
    ins = _inputs(np.random.default_rng(S * 10 + P + G), B, S, H, P, N, G)
    x, dt, A, Bm, Cm, dy = map(torch.from_numpy, ins)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    want = torch.autograd.grad(ssd_scan_ref(*leaves, chunk), leaves, dy)
    got = chunk_parallel_bwd(x, dt, A, Bm, Cm, dy, chunk)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float64
        err = _rel(a.numpy(), b.numpy())
        assert err <= 1e-10, f"{name}: {err:.3e}"


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", CASES)
def test_chunk_parallel_bwd_matches_jax_grad_fp32(B, S, H, P, N, chunk, G):
    ins = [a.astype(np.float32) for a in
           _inputs(np.random.default_rng(S * 10 + P + G + 1), B, S, H, P, N,
                   G)]
    x, dt, A, Bm, Cm, dy = ins

    def loss(x, dt, A, Bg, Cg):
        Bh, Ch = (jnp.repeat(t, H // G, axis=2) for t in (Bg, Cg))
        return jnp.sum(ssd_chunked(x, dt, A, Bh, Ch, chunk) * dy)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    got = chunk_parallel_bwd(*map(torch.from_numpy, ins), chunk)
    exact = chunk_parallel_bwd(
        *(torch.from_numpy(a.astype(np.float64)) for a in ins), chunk)
    for name, a, b, t in zip(NAMES, got, want, exact):
        assert a.dtype == torch.float32
        err = _rel(a.numpy(), b)
        tol = max(1e-5, 2 * _rel(b, t.numpy()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
