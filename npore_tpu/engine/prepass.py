"""Device prepass: unpack one packed window group and build the tables the
DP step reads.

A group travels to the device as ONE int32 array ``buf`` of shape
``(B, r_pad // 4 + SCAL)``. Per window, the first ``r_pad // 4`` words hold
``r_pad`` bytes (little-endian), one per position / anti-diagonal row:

    bits 0-2  ref base   (0 beyond the window's ref)
    bits 3-5  seq base   (0 beyond the window's seq)
    bit  6    D step of row t (1 - the step in prefix-I counts; 0 at t=0)

followed by ``SCAL`` scalars: b_rows, n_ins, n_del, ref_guard, seq_guard
(the rest zero). Padding windows are all zero (b_rows = 0).

From that buffer the prepass derives, on device:

* the prefix-I counts ``inss`` per row (constant past b_rows),
* n-polymer info (L, L_IDX == 0) for both sequences
  (ops/npinfo_device.py), and then either
* ``kernel_tables``: the position-linear words the CUDA kernel reads, or
* ``band_batch``: the batch dict of the plain scan (ops/band_dp.py).
"""
from __future__ import annotations

SCAL = 8          # scalar words per window after the byte plane
OFF = 64          # leading positions of the kernel tables (position -OFF)


def group_words(r_pad: int) -> int:
    return r_pad // 4 + SCAL


def unpack(buf, r_pad: int):
    """buf (B, group_words) int32 -> ref, seq, inss (B, r_pad) int32 and
    scal (B, SCAL) int32."""
    import jax
    import jax.numpy as jnp

    B = buf.shape[0]
    pk = jax.lax.bitcast_convert_type(buf[:, :r_pad // 4], jnp.uint8)
    pk = pk.reshape(B, r_pad).astype(jnp.int32)
    scal = buf[:, r_pad // 4:]
    t = jnp.arange(r_pad, dtype=jnp.int32)[None, :]
    istep = jnp.where((t >= 1) & (t < scal[:, 0:1]), 1 - ((pk >> 6) & 1), 0)
    inss = jnp.cumsum(istep, axis=1, dtype=jnp.int32)
    return pk & 7, (pk >> 3) & 7, inss, scal


def np_tables(ref, seq, max_n: int, max_l: int):
    """(L, LZ) planes (B, max_n, r_pad) for ref and seq, in one scan pass
    over both sides stacked on the batch axis."""
    import jax.numpy as jnp
    from ..ops.npinfo_device import np_info_device

    B = ref.shape[0]
    L, LZ = np_info_device(jnp.concatenate([ref, seq], axis=0), max_n, max_l)
    return L[:B], LZ[:B], L[B:], LZ[B:]


def _lin(x, fill):
    """(B, R) -> (B, R + 2*OFF) position-linear, ``fill`` outside."""
    import jax.numpy as jnp
    B = x.shape[0]
    pad = jnp.full((B, OFF), fill, x.dtype)
    return jnp.concatenate([pad, x, pad], axis=1)


def _shifted(x, d: int, fill):
    """y[:, i] = x[:, i + d] (static d), ``fill`` where i + d is outside."""
    import jax.numpy as jnp
    if d == 0:
        return x
    B, P = x.shape
    pad = jnp.full((B, abs(d)), fill, x.dtype)
    if d > 0:
        return jnp.concatenate([x[:, d:], pad], axis=1)
    return jnp.concatenate([pad, x[:, :P + d]], axis=1)


def kernel_tables(ref, seq, scal, Lr, LZr, Ls, LZs, max_n: int):
    """Position-linear words for the CUDA kernel (ops/cuda/dp_tb.cu).

    Index i holds position p = i - OFF, for p in [-OFF, r_pad + OFF).

    rw (B, P, 4) int32, read at p = a_col:
      w0  nibbles k=0..6: ref[p - 1 + k]
      w1  bytes n=1..4:   LL(p, n)
      w2  bytes:          LL(p, 5), LL(p, 6), LL(p - 1, 1), LL(p - 2, 2)
      w3  bytes n=3..6:   LL(p - n, n)
    with LL(q, n) = L_ref[q, n] | (L_IDX_ref[q, n] == 0) << 7, and L = 0,
    L_IDX = 0 at q >= ref_guard and outside the window (src/aln.pyx:510-521).

    sw (B, P, 2) int32, read at q = a_row - 1:
      w0  nibbles k=0..5: seq[q - 5 + k]
      w1  bits 2(n-1), 2(n-1)+1: L_seq[q+1-n, n] > 0, L_IDX_seq[q+1-n, n] == 0
    with the same guard at seq_guard.
    """
    import jax
    import jax.numpy as jnp

    B, R = ref.shape
    P = R + 2 * OFF
    pos = jnp.arange(P, dtype=jnp.int32)[None, :] - OFF
    u32 = jnp.uint32

    refl = _lin(ref, 0).astype(u32)
    w0 = sum(_shifted(refl, k - 1, u32(0)) << u32(4 * k) for k in range(7))

    rg = scal[:, 3:4]
    sg = scal[:, 4:5]
    dflt = u32(128)                     # L = 0, L_IDX == 0
    llr = []
    for ni in range(6):
        if ni >= max_n:
            llr.append(jnp.full((B, P), dflt, u32))
            continue
        b = (_lin(Lr[:, ni], 0) | (_lin(LZr[:, ni], 1) << 7)).astype(u32)
        llr.append(jnp.where(pos >= rg, dflt, b))
    lls = [_shifted(llr[ni], -(ni + 1), dflt) for ni in range(6)]
    w1 = llr[0] | llr[1] << 8 | llr[2] << 16 | llr[3] << 24
    w2 = llr[4] | llr[5] << 8 | lls[0] << 16 | lls[1] << 24
    w3 = lls[2] | lls[3] << 8 | lls[4] << 16 | lls[5] << 24
    rw = jnp.stack([w0, w1, w2, w3], axis=-1)

    seql = _lin(seq, 0).astype(u32)
    s0 = sum(_shifted(seql, k - 5, u32(0)) << u32(4 * k) for k in range(6))
    s1 = jnp.zeros((B, P), u32)
    for ni in range(max_n):
        n = ni + 1
        lp = _lin(Ls[:, ni], 0) > 0
        lz = _lin(LZs[:, ni], 1) > 0
        f = jnp.where(pos >= sg, u32(2),
                      lp.astype(u32) | (lz.astype(u32) << 1))
        s1 = s1 | (_shifted(f, 1 - n, u32(2)) << u32(2 * ni))
    sw = jnp.stack([s0, s1], axis=-1)
    i32 = jnp.int32
    return (jax.lax.bitcast_convert_type(rw, i32),
            jax.lax.bitcast_convert_type(sw, i32))


def band_batch(ref, seq, inss, scal, Lr, LZr, Ls, LZs, cont):
    """The batch dict of ops/band_dp.make_window_dp (layout of
    engine/windows.pack_batch), built on device. cont: (2, max_n, 101, 128)
    continuation table."""
    import jax.numpy as jnp
    from ..ops.band_dp import PADL

    B, R = ref.shape

    def pad2(x):
        return jnp.concatenate([jnp.zeros((B, PADL), x.dtype), x,
                                jnp.zeros((B, 40), x.dtype)], axis=1)

    def pad3(x):                        # (B, max_n, R) -> (B, A, max_n)
        m = x.shape[1]
        return jnp.concatenate([jnp.zeros((B, PADL, m), x.dtype),
                                jnp.swapaxes(x, 1, 2),
                                jnp.zeros((B, 40, m), x.dtype)], axis=1)

    cont = jnp.asarray(cont)
    ns = jnp.arange(Lr.shape[1])[None, :, None]
    len_start = cont[0, ns, Lr, 1]
    shr_start = cont[1, ns, Lr, 1]
    return {
        "seqbuf": pad2(seq), "refbuf": pad2(ref),
        "l_seq": pad3(Ls), "lidx_seq": pad3(1 - LZs),
        "l_ref": pad3(Lr), "lidx_ref": pad3(1 - LZr),
        "len_start": pad3(len_start), "shr_start": pad3(shr_start),
        "inss": jnp.concatenate([jnp.zeros((B, 8), jnp.int32), inss], 1),
        "b_rows": scal[:, 0], "n_ins": scal[:, 1], "n_del": scal[:, 2],
        "ref_guard": scal[:, 3], "seq_guard": scal[:, 4],
    }
