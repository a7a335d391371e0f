"""Kernels G1-G5: the BFV/RNS glue of the BEHZ multiply, the multiply-sum,
relinearization and mod-switch (``csrc/behz_lift.cu``, ``csrc/mont_mac.cu``,
``csrc/behz_scaledown.cu``, ``csrc/rns_divround.cu``), BFV's plaintext
scaling with the adds around it (``csrc/scale_add.cu``), and their plain
PyTorch versions.

The reference has no Pallas kernel for this glue: it runs as jitted XLA
programs (``apsu_tpu/core/bfv.py:_jitted``, the power wavefront's
``ps_power_tensors``, the PS chunk programs), inside which XLA fuses the u32
chains of ``core/mod32.py`` and ``core/rns.py`` into a few passes over the
residues.  These five kernels are the port's counterpart of those fused
stretches; the NTTs between them stay kernel 1's.

- G1 ``lift``: plain coefficient residues x [..., Lq, N] -> ``q.to_mont(x)``
  and ``bsk.to_mont(ExactLiftConv(x))`` in one read of x; ``scale`` (one
  base's to_mont/from_mont) and ``digits`` (relinearization's digits in Q·P,
  Montgomery form) are its two other modes.
- G2 ``mont_mac``: the tensor Σ_m (a0·b0, a0·b1 + a1·b0, a1·b1) of Montgomery
  products over M terms, canonical; ``keyswitch_mac`` is Σ_i d_i ⊙ ksk_i.
- G3 ``scaledown``: the INTT'd tensor in q and Bsk (Montgomery) -> plain
  [..., 3, Lq, N]: t/Q fast floor and Shenoy–Kumaresan, every residue of a
  coefficient in registers.
- G4 ``keyswitch_div`` (from_mont, ÷ P rounded, + c0, c1) and ``mod_switch``
  (the rounded drops from level l to r, one limb at a time in registers).
- G5 ``delta`` (Δ·m = round(Q·m/t) mod q_j of plaintext coefficients),
  ``delta_add`` (Δ·m added in place into a ciphertext's component, with the
  Montgomery form of chosen planes written beside it) and ``add_into`` (an
  in-place add of two residue tensors): the PS evaluation's constant term and
  mask, and every ``BfvContext._scale_impl`` on the card.

G3 and G1's lift are built for each (q limbs, Bsk limbs) pair of
``exact_pairs()`` with loops of exactly that length and lazy 64-bit sums, and
once more for any other pair (the general build, whose launches are also
counted on their own: no parameter file reaches it).

Every value is a canonical residue, so each kernel equals its plain version
bit for bit whatever order it sums in.  A wrapper launches its kernel for a
CUDA tensor and runs the plain version only for a CPU tensor: there is no
fallback.  G5's ``delta_add`` and ``add_into`` write into their first
operand, a view that the kernel addresses in place (a layout it would have
to copy is refused).  Each kernel is bound by device-memory bytes (each
input read once, each output written once), G3 by its multiplies about as
much; one thread per coefficient lane holds every limb in registers and
loads along N are coalesced.  The constant tables come from ``core/rns.py``
(``RnsBase.to_mont_table``, ``ExactLiftConv.table``, ``ScaleDown.table``,
``ExactDiv.table``, ``RnsBase.mod_table``, ``DeltaScale.table``) and go to
each kernel by value.
"""

from __future__ import annotations

import functools
import math
import re

import torch

from apsu_tpu_torch.core.mod32 import I32, I64, add_mod, mont_mul, shoup_mul, sub_mod
from apsu_tpu_torch.ops import _build

# kernel launches since the last reset (set to 0 to reset); a launch captured
# into a CUDA graph is counted at each replay (``ops/counts.py``)
lift_launches = 0        # G1
mac_launches = 0         # G2
scaledown_launches = 0   # G3
divround_launches = 0    # G4
scale_add_launches = 0   # G5
# of those, the launches of G1's lift and of G3 on their general builds
lift_general_launches = 0
scaledown_general_launches = 0

# the kernels' limits (csrc/behz.cuh): q (or Q·P) limbs, Bsk limbs, limbs of
# any one base
MAXQ, MAXB, MAXL = 10, 12, 12
_LIFT, _DIGITS, _SCALE = 0, 1, 2
_TENSOR, _KEYSWITCH = 0, 1
_DELTA, _DELTA_ADD, _ADD = 0, 1, 2


@functools.cache
def exact_pairs() -> frozenset:
    """The (q limbs, Bsk limbs) pairs that G3 and G1's lift are built for
    exactly: ``BEHZ_EXACT_PAIRS`` of ``csrc/behz.cuh``, the one list of them."""
    text = (_build.CSRC / "behz.cuh").read_text()
    body = re.search(r"#define BEHZ_EXACT_PAIRS\(X\)((?:.*\\\n)*.*)", text).group(1)
    return frozenset((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body))


def _check(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x.dtype != I32:
        raise TypeError(f"{name} needs int32 residues, got {x.dtype}")


def _runs(shape, strides) -> list:
    """The axes of ``shape`` (size 1 left out) merged into runs of uniform
    stride, outermost first: [[size, stride], ...]."""
    runs = []
    for s, st in zip(shape, strides):
        if s == 1:
            continue
        if runs and runs[-1][1] == st * s:
            runs[-1] = [runs[-1][0] * s, st]
        else:
            runs.append([s, st])
    return runs


def _rows(x: torch.Tensor, tail: int):
    """(x, rows, (inner, stride, outer)): row r of ``x``'s leading axes (all
    but the last ``tail``) starts at (r // inner) * outer + (r % inner) *
    stride (``behz.cuh``'s Rows), so a view of two runs of uniform stride,
    such as a slice of a middle axis, is read in place.  The lanes (last
    axis) must be contiguous; a layout that is not so, or whose leading axes
    form three runs or more, is copied first."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    runs = _runs(x.shape[:-tail], x.stride()[:-tail])
    if len(runs) > 2:
        x = x.contiguous()
        runs = _runs(x.shape[:-tail], x.stride()[:-tail])
    rows = math.prod(x.shape[:-tail])
    if rows >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 rows, got {rows}")
    if len(runs) == 2:
        (_, outer), (inner, stride) = runs
        return x, rows, (inner, stride, outer)
    return x, rows, ((runs[0][0], runs[0][1], 0) if runs else (1, 0, 0))


def _launch(name, entry, x, *args):
    return _build.launch(name, entry, x.get_device(), *args)


# ---------------------------------------------------------------------------
# G1: to_mont / from_mont, the exact lift q -> Bsk, relinearization digits
# ---------------------------------------------------------------------------

def scale_plain(x, base, inverse: bool = False):
    """x·R mod p (x·R^{-1} when ``inverse``) per limb of ``base``."""
    return shoup_mul(x, *(base.rinv_sh if inverse else base.r1_sh), base.p_d)


def lift_plain(x, conv, want_q: bool = True):
    """(``q.to_mont(x)`` or None, ``bsk.to_mont(ExactLiftConv(x))``) for plain
    residues x [..., Lq, N] of ``conv.src``."""
    xb = scale_plain(conv(x), conv.dst)
    return (scale_plain(x, conv.src) if want_q else None), xb


def digits_plain(c2, qp, k: int):
    """Relinearization digits of c2 [..., k, N] (plain, digit i < q_i) in Q·P,
    Montgomery form: [k, ..., Lqp, N]."""
    d = torch.stack([c2[..., i: i + 1, :] for i in range(k)])
    return shoup_mul(d, *qp.r1_sh, qp.p_d)


def _g1(x, table, out_q_limbs, out_b_shape, rows_shape, mode, lq, lb):
    global lift_launches, lift_general_launches
    _check(x, "behz_lift")
    n = x.shape[-1]
    x, rows, xw = _rows(x, 2)
    out_b = torch.empty(out_b_shape, dtype=I32, device=x.device) if out_b_shape else None
    out_q = (torch.empty(rows_shape + (out_q_limbs, n), dtype=I32, device=x.device)
             if out_q_limbs else None)
    if rows:
        launched = _launch(
            "behz_lift", _build.lib().apsu_behz_lift, x, x.data_ptr(), *xw, x.stride(-2),
            out_q.data_ptr() if out_q is not None else None,
            out_b.data_ptr() if out_b is not None else None, rows, n, lq, lb, mode,
            table.ctypes.data)
        lift_launches += launched
        if mode == _LIFT and (lq, lb) not in exact_pairs():
            lift_general_launches += launched
    return out_q, out_b


def scale(x, base, inverse: bool = False):
    """x·R mod p, or x·R^{-1} when ``inverse``, per limb of ``base``: x
    [..., k, N] int32 (any value < 2^32 as u32 bits in, canonical out)."""
    if x.device.type == "cpu":
        return scale_plain(x, base, inverse)
    return scale_cuda(x, base, inverse)


def scale_cuda(x, base, inverse: bool = False):
    k, n = base.k, base.n
    if x.dim() < 2 or x.shape[-2] != k or x.shape[-1] != n:
        raise ValueError(f"scale needs [..., {k}, {n}], got {tuple(x.shape)}")
    if k > MAXB:
        raise ValueError(f"scale takes at most {MAXB} limbs")
    table = base.from_mont_table if inverse else base.to_mont_table
    return _g1(x, table, 0, tuple(x.shape), None, _SCALE, 0, k)[1]


def lift(x, conv, want_q: bool = True):
    """The two NTT-free forms a BEHZ multiply needs of plain coefficient
    residues x [..., Lq, N]: (``q.to_mont(x)``, or None unless ``want_q``,
    and ``bsk.to_mont(ExactLiftConv(x))`` [..., Lb, N])."""
    if x.device.type == "cpu":
        return lift_plain(x, conv, want_q)
    return lift_cuda(x, conv, want_q)


def lift_cuda(x, conv, want_q: bool = True):
    q, bsk = conv.src, conv.dst
    if x.dim() < 2 or x.shape[-2] != q.k or x.shape[-1] != q.n:
        raise ValueError(f"lift needs [..., {q.k}, {q.n}], got {tuple(x.shape)}")
    if q.k > MAXQ or bsk.k > MAXB:
        raise ValueError(f"lift takes at most {MAXQ} -> {MAXB} limbs")
    lead = tuple(x.shape[:-2])
    return _g1(x, conv.table, q.k if want_q else 0, lead + (bsk.k, q.n), lead, _LIFT,
               q.k, bsk.k)


def digits(c2, qp, k: int):
    """Relinearization's digits: c2 [..., k, N] plain (digit i < q_i) ->
    ``qp.to_mont`` of each digit in every Q·P limb, [k, ..., Lqp, N]."""
    if c2.device.type == "cpu":
        return digits_plain(c2, qp, k)
    return digits_cuda(c2, qp, k)


def digits_cuda(c2, qp, k: int):
    if c2.dim() < 2 or c2.shape[-2] != k or c2.shape[-1] != qp.n:
        raise ValueError(f"digits needs [..., {k}, {qp.n}], got {tuple(c2.shape)}")
    if k > MAXQ or qp.k > MAXQ:
        raise ValueError(f"digits takes at most {MAXQ} digits and limbs")
    lead = tuple(c2.shape[:-2])
    return _g1(c2, qp.to_mont_table, 0, (k,) + lead + (qp.k, qp.n), None, _DIGITS, k,
               qp.k)[1]


# ---------------------------------------------------------------------------
# G2: Montgomery multiply-accumulate (the BEHZ tensor, the key-switch sum)
# ---------------------------------------------------------------------------

def mont_mac_plain(fa, fb, base):
    """Σ_m tensor(fa[m], fb[m]) in ``base``'s NTT-Montgomery domain: fa, fb
    [..., M, 2, L, N] (broadcastable) -> [..., 3, L, N] canonical."""
    p, pni = base.p_d, base.pni_d
    c0 = mont_mul(fa[..., 0, :, :], fb[..., 0, :, :], p, pni)
    c2 = mont_mul(fa[..., 1, :, :], fb[..., 1, :, :], p, pni)
    c1 = add_mod(
        mont_mul(fa[..., 0, :, :], fb[..., 1, :, :], p, pni),
        mont_mul(fa[..., 1, :, :], fb[..., 0, :, :], p, pni),
        p,
    )
    f = torch.stack([c0, c1, c2], dim=-3)  # [..., M, 3, L, N]
    # modular sum over M: canonical terms, exact in int64
    return torch.remainder(f.to(I64).sum(dim=-4), p).to(I32)


def _key_rows(ksk, lvl: int, klvl: int):
    """The key restricted to level ``lvl``: digit rows 0..lvl-1 and limb
    columns {0..lvl-1, special}, the special column at ``klvl`` (slices,
    no index uploaded from the host)."""
    return torch.cat([ksk[:lvl, :, :lvl], ksk[:lvl, :, klvl:klvl + 1]], dim=2)


def keyswitch_mac_plain(d, ksk, qp, lvl: int, klvl: int):
    """Σ_i d_i ⊙ ksk_i: digits d [k, ..., Lqp, N] (NTT mont), key ksk
    [K, 2, Lqk, N] restricted to level ``lvl`` (k = lvl) -> [..., 2, Lqp, N]."""
    key = _key_rows(ksk, lvl, klvl)
    key = key.reshape((lvl,) + (1,) * (d.dim() - 3) + tuple(key.shape[1:]))
    terms = mont_mul(d[..., None, :, :], key, qp.p_d, qp.pni_d)  # [k, ..., 2, Lqp, N]
    return torch.remainder(terms.to(I64).sum(dim=0), qp.p_d).to(I32)


def _geom(t, lead):
    """How output row r of the flattened ``lead`` finds its row of ``t``
    ([..., M, C, L, N], broadcastable against lead): (t, div, mod, stride),
    t's row being ((r // div) % mod) * stride, with t copied to ``lead``'s
    shape when its broadcast is not of that form."""
    k = len(lead)
    shape = (1,) * (k - (t.dim() - 4)) + tuple(t.shape[:-4])
    strides = (0,) * (k - (t.dim() - 4)) + tuple(t.stride()[:-4])
    live = [d for d in range(k) if shape[d] != 1]
    if not live:
        return t, 1, 1, 0
    i, j = live[0], live[-1] + 1
    run = [d for d in range(i, j) if lead[d] != 1]
    ok = all(shape[d] == lead[d] for d in run) and all(
        strides[a] == strides[b] * shape[b] for a, b in zip(run, run[1:]))
    if not ok:
        t = t.expand(tuple(lead) + tuple(t.shape[-4:])).contiguous()
        return t, 1, math.prod(lead), math.prod(t.shape[-4:])
    return t, math.prod(lead[j:]), math.prod(lead[i:j]), strides[run[-1]]


def mont_mac(fa, fb, base):
    """Σ_m tensor(fa[m], fb[m]) (G2, tensor mode): fa, fb [..., M, 2, L, N]
    NTT-Montgomery residues of ``base``, their leading axes broadcastable ->
    [..., 3, L, N] canonical Montgomery residues."""
    if fa.device.type == "cpu":
        return mont_mac_plain(fa, fb, base)
    return mont_mac_cuda(fa, fb, base)


def _tail_strides(t, m_terms):
    m_st = t.stride(-4) if t.shape[-4] != 1 or m_terms == 1 else 0
    return m_st, t.stride(-3), t.stride(-2)


def mont_mac_cuda(fa, fb, base):
    global mac_launches
    for t in (fa, fb):
        _check(t, "mont_mac")
        if t.dim() < 4 or tuple(t.shape[-3:]) != (2, base.k, base.n):
            raise ValueError(f"mont_mac needs [..., M, 2, {base.k}, {base.n}], "
                             f"got {tuple(t.shape)}")
    if base.k > MAXL:
        raise ValueError(f"mont_mac takes at most {MAXL} limbs")
    if fa.shape[-4] != fb.shape[-4] and 1 not in (fa.shape[-4], fb.shape[-4]):
        raise ValueError(f"mont_mac's term axes differ: {fa.shape[-4]} and {fb.shape[-4]}")
    M = max(fa.shape[-4], fb.shape[-4])
    lead = tuple(torch.broadcast_shapes(fa.shape[:-4], fb.shape[:-4]))
    out = torch.empty(lead + (3, base.k, base.n), dtype=I32, device=fa.device)
    rows = math.prod(lead)
    if fa.stride(-1) != 1:
        fa = fa.contiguous()
    if fb.stride(-1) != 1:
        fb = fb.contiguous()
    fa, *ga = _geom(fa, lead)
    fb, *gb = _geom(fb, lead)
    if rows:
        mac_launches += _launch(
            "mont_mac", _build.lib().apsu_mont_mac, fa, fa.data_ptr(), *ga,
            *_tail_strides(fa, M), fb.data_ptr(), *gb, *_tail_strides(fb, M), out.data_ptr(),
            rows, M, base.k, base.n, _TENSOR, base.k - 1, base.mod_table.ctypes.data)
    return out


def keyswitch_mac(d, ksk, qp, lvl: int, klvl: int):
    """Σ_i d_i ⊙ ksk_i (G2, key-switch mode) over the ``lvl`` digits d [lvl,
    ..., Lqp, N] (NTT mont) with the key ksk [K, 2, klvl + 1, N] generated at
    ``klvl`` and read at level ``lvl`` -> [..., 2, Lqp, N]."""
    if d.device.type == "cpu":
        return keyswitch_mac_plain(d, ksk, qp, lvl, klvl)
    return keyswitch_mac_cuda(d, ksk, qp, lvl, klvl)


def keyswitch_mac_cuda(d, ksk, qp, lvl: int, klvl: int):
    global mac_launches
    _check(d, "keyswitch_mac")
    _check(ksk, "keyswitch_mac")
    L, n = qp.k, qp.n
    if d.dim() < 3 or d.shape[0] != lvl or tuple(d.shape[-2:]) != (L, n) or L != lvl + 1:
        raise ValueError(f"keyswitch_mac needs digits [{lvl}, ..., {lvl + 1}, {n}], "
                         f"got {tuple(d.shape)}")
    if ksk.dim() != 4 or ksk.shape[0] < lvl or ksk.shape[1] != 2 or ksk.shape[2] != klvl + 1:
        raise ValueError(f"keyswitch_mac needs a key [>={lvl}, 2, {klvl + 1}, {n}], "
                         f"got {tuple(ksk.shape)}")
    if L > MAXL:
        raise ValueError(f"keyswitch_mac takes at most {MAXL} limbs")
    d = d.contiguous()
    ksk = ksk.contiguous()
    lead = tuple(d.shape[1:-2])
    rows = math.prod(lead)
    out = torch.empty(lead + (2, L, n), dtype=I32, device=d.device)
    if rows:
        mac_launches += _launch(
            "mont_mac", _build.lib().apsu_mont_mac, d, d.data_ptr(), 1, rows, L * n,
            rows * L * n, 0, n, ksk.data_ptr(), 1, 1, 0, 2 * (klvl + 1) * n,
            (klvl + 1) * n, n, out.data_ptr(), rows, lvl, L, n, _KEYSWITCH, klvl,
            qp.mod_table.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# G3: BEHZ scale-down (t/Q fast floor, Shenoy–Kumaresan)
# ---------------------------------------------------------------------------

def scaledown_plain(x_q, x_b, sd):
    """x_q [..., Lq, N] and x_b [..., Lb, N] Montgomery (the INTT'd tensor in
    q and Bsk) -> round(t·x/Q) mod q [..., Lq, N] plain (``ScaleDown``)."""
    return sd(scale_plain(x_q, sd.q, True), scale_plain(x_b, sd.bsk, True))


def scaledown(x_q, x_b, sd):
    """G3: the BEHZ scale-down of a tensor product from its INTT'd
    Montgomery residues in q and in Bsk (``sd`` a ``ScaleDown``)."""
    if x_q.device.type == "cpu":
        return scaledown_plain(x_q, x_b, sd)
    return scaledown_cuda(x_q, x_b, sd)


def scaledown_cuda(x_q, x_b, sd):
    global scaledown_launches, scaledown_general_launches
    q, bsk = sd.q, sd.bsk
    _check(x_q, "behz_scaledown")
    _check(x_b, "behz_scaledown")
    if (tuple(x_q.shape[-2:]) != (q.k, q.n) or tuple(x_b.shape[-2:]) != (bsk.k, q.n)
            or x_q.shape[:-2] != x_b.shape[:-2]):
        raise ValueError(f"behz_scaledown needs [..., {q.k}, {q.n}] and [..., {bsk.k}, "
                         f"{q.n}], got {tuple(x_q.shape)} and {tuple(x_b.shape)}")
    if q.k > MAXQ or bsk.k > MAXB or bsk.k < 2:
        raise ValueError(f"behz_scaledown takes at most {MAXQ} q and 2..{MAXB} Bsk limbs")
    x_q, x_b = x_q.contiguous(), x_b.contiguous()
    out = torch.empty_like(x_q)
    rows = x_q.numel() // (q.k * q.n)
    if rows:
        launched = _launch(
            "behz_scaledown", _build.lib().apsu_behz_scaledown, x_q, x_q.data_ptr(),
            x_b.data_ptr(), out.data_ptr(), rows, q.n, q.k, bsk.k, sd.table.ctypes.data)
        scaledown_launches += launched
        if (q.k, bsk.k) not in exact_pairs():
            scaledown_general_launches += launched
    return out


# ---------------------------------------------------------------------------
# G4: rounded exact division (key-switch mod-down, mod-switch)
# ---------------------------------------------------------------------------

def keyswitch_div_plain(u, data, qp, div):
    """data[..., :2] + round(from_mont(u)/P) mod q: u [..., 2, Lq+1, N] (the
    INTT'd key-switch sum in Q·P), data [..., >=2, Lq, N] plain."""
    k = div.q.k
    u = scale_plain(u, qp, True)
    return add_mod(data[..., :2, :, :], div(u[..., :k, :], u[..., k:, :]), div.q.p_d)


def keyswitch_div(u, data, qp, div):
    """G4, key-switch mode: the relinearized (c0, c1) [..., 2, Lq, N] from
    the INTT'd key-switch sum u and the ciphertext data (``div`` the
    ``ExactDiv`` by the special prime at this level)."""
    if u.device.type == "cpu":
        return keyswitch_div_plain(u, data, qp, div)
    return keyswitch_div_cuda(u, data, qp, div)


def _g4(x, xw, c, cw, c_comp, out, rows, n, top, target, mode, table):
    global divround_launches
    if rows:
        divround_launches += _launch(
            "rns_divround", _build.lib().apsu_rns_divround, x, x.data_ptr(), *xw,
            c.data_ptr() if c is not None else None, *cw, c_comp, out.data_ptr(), rows, n,
            top, target, mode, table.ctypes.data)
    return out


def keyswitch_div_cuda(u, data, qp, div):
    k, n = div.q.k, div.q.n
    _check(u, "rns_divround")
    _check(data, "rns_divround")
    if tuple(u.shape[-3:]) != (2, k + 1, n) or qp.k != k + 1:
        raise ValueError(f"keyswitch_div needs u [..., 2, {k + 1}, {n}], got {tuple(u.shape)}")
    if data.dim() < 3 or data.shape[-3] < 2 or tuple(data.shape[-2:]) != (k, n) \
            or data.shape[:-3] != u.shape[:-3]:
        raise ValueError(f"keyswitch_div needs data [..., >=2, {k}, {n}], "
                         f"got {tuple(data.shape)}")
    if k + 1 > MAXQ:
        raise ValueError(f"keyswitch_div takes at most {MAXQ} limbs")
    u = u.contiguous()
    if data.stride(-1) != 1 or data.stride(-2) != n:
        data = data.contiguous()
    data, rows, cw = _rows(data, 3)
    out = torch.empty(tuple(u.shape[:-3]) + (2, k, n), dtype=I32, device=u.device)
    # one row a (ciphertext row, component): u's rows follow each other
    return _g4(u, (max(2 * rows, 1), (k + 1) * n, 0), data, cw, data.stride(-3), out,
               2 * rows, n, k + 1, k, 0, div.table)


def mod_switch_plain(x, divs, top: int, target: int):
    """The rounded drops of x [..., top, N] plain down to ``target`` limbs,
    one limb at a time (``divs[l]`` divides level l by its last limb)."""
    while top > target:
        x = divs[top](x[..., : top - 1, :], x[..., top - 1:, :])
        top -= 1
    return x


def mod_switch(x, divs, top: int, target: int):
    """G4, mod-switch mode: x [..., top, N] plain -> [..., target, N], the
    same rounding at each step as the sequential drops."""
    if x.device.type == "cpu":
        return mod_switch_plain(x, divs, top, target)
    return mod_switch_cuda(x, divs, top, target)


def mod_switch_cuda(x, divs, top: int, target: int):
    div = divs[top]
    n = div.q.n
    _check(x, "rns_divround")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (top, n) or not 1 <= target < top:
        raise ValueError(f"mod_switch needs [..., {top}, {n}] and 1 <= target < {top}, "
                         f"got {tuple(x.shape)} -> {target}")
    if top > MAXQ:
        raise ValueError(f"mod_switch takes at most {MAXQ} limbs")
    if x.stride(-2) != n:
        x = x.contiguous()
    x, rows, xw = _rows(x, 2)
    out = torch.empty(tuple(x.shape[:-2]) + (target, n), dtype=I32, device=x.device)
    return _g4(x, xw, None, (1, 0, 0), 0, out, rows, n, top, target, 1, div.table)


# ---------------------------------------------------------------------------
# G5: BFV's plaintext scaling and the adds that fold it into a ciphertext
# ---------------------------------------------------------------------------

def delta_plain(m, ds):
    """Δ·m = round(Q·m/t) mod q_j of plaintext coefficients m [..., N] < t at
    ``ds``'s level (a ``DeltaScale``): plain residues [..., L, N]."""
    q, t = ds.q, ds.t
    rem = add_mod(shoup_mul(m[..., None, :], ds.rt, ds.rt_sh, t), ds.h, t)   # [..., 1, N] < t
    diff = sub_mod(ds.hq, rem, q.p_d)   # rem < t < q_j: a residue mod q_j
    return shoup_mul(diff, *ds.tinv_sh, q.p_d)


def delta_add_plain(x, m, ds, mont_skip=None):
    """x [..., L, N] += Δ·m mod q in place, m [..., N] < t.  Returns (x, the
    Montgomery form of Δ·m's planes mont_skip.. along m's axis -2, or
    None)."""
    dm = delta_plain(m, ds)
    x[...] = add_mod(x, dm, ds.q.p_d)
    return x, None if mont_skip is None else scale_plain(dm[..., mont_skip:, :, :], ds.q)


def add_into_plain(x, y, ds):
    """x [..., L, N] += y mod q in place (``ds``'s level q); returns x."""
    x[...] = add_mod(x, y, ds.q.p_d)
    return x


def _in_place(x, tail, name):
    """``_rows`` of an operand written in place: a layout that ``_rows``
    would copy is refused."""
    if x.stride(-1) != 1 or len(_runs(x.shape[:-tail], x.stride()[:-tail])) > 2:
        raise ValueError(f"{name} writes in place: lanes contiguous and leading axes of at "
                         f"most two runs, got strides {tuple(x.stride())}")
    return _rows(x, tail)


def _g5(mode, ds, rows, like, m=None, mw=(1, 0, 0), x=None, xw=(1, 0, 0), y=None,
        yw=(1, 0, 0), out=None, period=1, skip=0):
    global scale_add_launches
    q = ds.q
    if q.k > MAXQ:
        raise ValueError(f"scale_add takes at most {MAXQ} limbs")
    if rows:
        scale_add_launches += _launch(
            "scale_add", _build.lib().apsu_scale_add, like,
            m.data_ptr() if m is not None else None, *mw,
            x.data_ptr() if x is not None else None, *xw, x.stride(-2) if x is not None else 0,
            y.data_ptr() if y is not None else None, *yw, y.stride(-2) if y is not None else 0,
            out.data_ptr() if out is not None else None, period, skip, rows, q.n, q.k, mode,
            ds.table.ctypes.data)


def delta(m, ds):
    """G5, scale mode: Δ·m [..., L, N] of plaintext coefficients m [..., N]
    (``core/bfv.py:_scale_impl``)."""
    if m.device.type == "cpu":
        return delta_plain(m, ds)
    return delta_cuda(m, ds)


def delta_cuda(m, ds):
    q = ds.q
    _check(m, "scale_add")
    if m.dim() < 1 or m.shape[-1] != q.n:
        raise ValueError(f"delta needs [..., {q.n}], got {tuple(m.shape)}")
    m, rows, mw = _rows(m, 1)
    out = torch.empty(tuple(m.shape[:-1]) + (q.k, q.n), dtype=I32, device=m.device)
    _g5(_DELTA, ds, rows, m, m=m, mw=mw, out=out)
    return out


def delta_add(x, m, ds, mont_skip=None):
    """G5, scale-add mode: x [..., L, N] (a view, written in place) +=
    Δ·m, m [..., N] < t.  Returns (x, None), or with ``mont_skip`` (x, the
    Montgomery form of Δ·m of the planes mont_skip.. along m's axis -2,
    [..., P - mont_skip, L, N]): the PS evaluation's constant term, whose
    planes 1..nh kernel 1 transforms next."""
    if x.device.type == "cpu":
        return delta_add_plain(x, m, ds, mont_skip)
    return delta_add_cuda(x, m, ds, mont_skip)


def delta_add_cuda(x, m, ds, mont_skip=None):
    q = ds.q
    _check(x, "scale_add")
    _check(m, "scale_add")
    if (x.dim() < 2 or tuple(x.shape[-2:]) != (q.k, q.n)
            or tuple(m.shape) != tuple(x.shape[:-2]) + (q.n,)):
        raise ValueError(f"delta_add needs x [..., {q.k}, {q.n}] and m [..., {q.n}], got "
                         f"{tuple(x.shape)} and {tuple(m.shape)}")
    x, rows, xw = _in_place(x, 2, "delta_add")
    m, _, mw = _rows(m, 1)
    out, period, skip = None, 1, 0
    if mont_skip is not None:
        if m.dim() < 2 or not 0 <= mont_skip < m.shape[-2]:
            raise ValueError(f"mont_skip {mont_skip} outside m's axis -2 {tuple(m.shape)}")
        period, skip = m.shape[-2], mont_skip
        out = torch.empty(tuple(m.shape[:-2]) + (period - skip, q.k, q.n), dtype=I32,
                          device=m.device)
    _g5(_DELTA_ADD, ds, rows, x, m=m, mw=mw, x=x, xw=xw, out=out, period=period, skip=skip)
    return x, out


def add_into(x, y, ds):
    """G5, add mode: x [..., L, N] (a view, written in place) += y mod q,
    y of x's shape; returns x."""
    if x.device.type == "cpu":
        return add_into_plain(x, y, ds)
    return add_into_cuda(x, y, ds)


def add_into_cuda(x, y, ds):
    q = ds.q
    _check(x, "scale_add")
    _check(y, "scale_add")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (q.k, q.n) or x.shape != y.shape:
        raise ValueError(f"add_into needs two [..., {q.k}, {q.n}] of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    x, rows, xw = _in_place(x, 2, "add_into")
    y, _, yw = _rows(y, 2)
    _g5(_ADD, ds, rows, x, x=x, xw=xw, y=y, yw=yw)
    return x
