"""The algebra of the SSD scan's chunk-parallel forward, on the CPU.

On the card, bf16 inputs run the forward of ``csrc/ssd_scan.cu`` as three
kernels: (a') per chunk, its decays and U_c = sum_s exp(g_Q - g_s) dt_s x_s
B_s^T; (b') per state entry, the forward pass that turns U into the
chunk-start states S_c; (c') per chunk, y_t = sum_s (C_t.B_s) L_ts dt_s x_s
+ exp(g_t) S_c C_t.  ``chunk_parallel_fwd`` below is a plain mirror of
those three phases, written from the formulas at the top of
``csrc/ssd_scan.cu``; (a') and (b') are the backward mirror's phases (a)
and (b) without V (``tests/test_torch_ssd_bwd.py``).  It is not part of
the package.  It proves the bookkeeping the chunk split adds (S_c shifted
by one chunk, the ragged tail, G groups of heads) before the kernels run on
the card.

Held against the port's ``kernels/ref.py::ssd_scan_ref`` in float64 to
1e-10 of y's largest magnitude (the same function, summed in another
order), and against the JAX package's ``models/ssm.py::ssd_chunked`` and
``kernels/ref.py::ssd_scan_ref`` in fp32 to 1e-5 (fp32 sums in another
order).  The Pallas kernel ``ssd_scan(interpret=True)`` does not run under
the installed jax (``pl.load`` is missing), so these jnp oracles stand in
for it.  Also: the ctypes argument lists of the SSD launchers match the C
signatures.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import BWD_ARGTYPES, FWD_ARGTYPES
from test_torch_ssd_bwd import (_inputs, _rel, chunk_decays, chunk_state_u,
                                chunked, pass_states)

torch.set_num_threads(1)


def chunk_parallel_fwd(x, dt, A, Bm, Cm, chunk):
    """y of ssd_scan(x, dt, A, Bm, Cm) in the dtype of x, by the three
    phases of the card's bf16 forward.  Bm/Cm are (B,S,G,N), G dividing
    H."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[-2]
    Q, nc, chunks = chunked(S, chunk)
    xc, dtc = chunks(x), chunks(dt)
    Bc = chunks(Bm.repeat_interleave(H // G, dim=2))
    Cc = chunks(Cm.repeat_interleave(H // G, dim=2))

    # (a') per chunk: decays and U
    g, e, _, w, decay = chunk_decays(dtc, A)
    U = chunk_state_u(w, xc, Bc)

    # (b') per entry: U -> chunk-start states, in place
    Sst = pass_states(U, decay)

    # (c') per chunk: M = (C_t . B_s) L_ts dt_s, y = M x + exp(g_t) S_c C_t
    iq = torch.arange(Q)
    on_or_below = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    delta = g[:, :, :, None, :] - g[:, :, None, :, :]     # (B,nc,t,s,H)
    L = torch.exp(torch.where(on_or_below, delta,
                              torch.full_like(delta, -torch.inf)))
    M = (torch.einsum("bcthn,bcshn->bctsh", Cc, Bc) * L
         * dtc[:, :, None, :, :])
    y = (torch.einsum("bctsh,bcshp->bcthp", M, xc)
         + e[..., None] * torch.einsum("bchpn,bcthn->bcthp", Sst, Cc))
    return y.reshape(Bsz, nc * Q, H, P)[:, :S]


# (B, S, H, P, N, chunk, G): ragged S over many chunks, S below the chunk,
# chunks of 16, 32 and 64, 1, 2 and 3 groups, odd P and N
CASES = [(2, 333, 4, 8, 16, 64, 2), (1, 1100, 2, 8, 8, 64, 1),
         (2, 40, 3, 8, 4, 64, 3), (1, 300, 3, 33, 37, 32, 1),
         (2, 100, 6, 8, 12, 16, 2), (1, 96, 6, 16, 16, 32, 3),
         (1, 333, 2, 4, 6, 16, 2)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", CASES)
def test_chunk_parallel_fwd_matches_ref_float64(B, S, H, P, N, chunk, G):
    ins = _inputs(np.random.default_rng(S * 10 + P + G), B, S, H, P, N, G)
    x, dt, A, Bm, Cm, _ = map(torch.from_numpy, ins)
    got = chunk_parallel_fwd(x, dt, A, Bm, Cm, chunk)
    want = ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    assert got.dtype == torch.float64 and got.shape == (B, S, H, P)
    err = _rel(got.numpy(), want.numpy())
    assert err <= 1e-10, f"{err:.3e}"


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", CASES)
def test_chunk_parallel_fwd_matches_jax_fp32(B, S, H, P, N, chunk, G):
    ins = [a.astype(np.float32) for a in
           _inputs(np.random.default_rng(S * 10 + P + G + 1), B, S, H, P, N,
                   G)]
    x, dt, A, Bm, Cm, _ = ins
    got = chunk_parallel_fwd(*map(torch.from_numpy, ins[:5]), chunk)
    assert got.dtype == torch.float32
    Bh, Ch = (jnp.repeat(jnp.asarray(t), H // G, axis=2) for t in (Bm, Cm))
    args = (jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), Bh, Ch, chunk)
    for name, fn in (("ssd_chunked", ssd_chunked),
                     ("ssd_scan_ref", jax_ssd_scan_ref)):
        err = _rel(got.numpy(), np.asarray(fn(*args)))
        assert err <= 1e-5, f"{name}: {err:.3e}"


@pytest.mark.parametrize("entry,argtypes", [("ssd_scan_fwd", FWD_ARGTYPES),
                                            ("ssd_scan_bwd", BWD_ARGTYPES)])
def test_ssd_binding_matches_the_c_signature(entry, argtypes):
    """The ctypes argument list has one entry per parameter of the C
    launcher, pointers as c_void_p (a short list shifts every argument; the
    strides are a pointer to long long)."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        if p.startswith("const long long*"):
            assert t == ctypes.POINTER(ctypes.c_longlong), p
        else:
            assert t is (ctypes.c_void_p if "*" in p else ctypes.c_int), p
