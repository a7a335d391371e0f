"""The port's BFV operations against apsu_tpu.core.bfv at 256K-2048-com, bit
for bit, with both packages drawing from the same numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.bfv import Ciphertext as RefCt
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu_torch.core.bfv import BfvContext, Ciphertext, RelinKey, SecretKey
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams

PARAMS = "parameters/256K-2048-com.json"


def _eq(ref_arr, port_t):
    return np.array_equal(np.asarray(jax.device_get(ref_arr)), to_u32(port_t))


@pytest.fixture(scope="module")
def ctx():
    ref = RefBfv(RefParams.load_file(PARAMS).seal_params)
    port = BfvContext(PSUParams.load_file(PARAMS).seal_params, device="cpu")
    r_rng, p_rng = np.random.default_rng(1), np.random.default_rng(1)
    r_sk, p_sk = ref.gen_secret_key(r_rng), port.gen_secret_key(p_rng)
    lvl = ref.q.k
    r_rk = ref.gen_relin_key(r_sk, r_rng, level=lvl)
    p_rk = port.gen_relin_key(p_sk, p_rng, level=lvl)
    slots = np.random.default_rng(2).integers(0, ref.t, size=(2, 3, ref.n), dtype=np.uint64)
    slots = slots.astype(np.uint32)
    r_ct = ref.encrypt_symmetric(ref.encode(slots), r_sk, r_rng)
    p_ct = port.encrypt_symmetric(port.encode(slots), p_sk, p_rng)
    return dict(ref=ref, port=port, r_sk=r_sk, p_sk=p_sk, r_rk=r_rk, p_rk=p_rk,
                slots=slots, r_ct=r_ct, p_ct=p_ct)


def test_keygen_matches(ctx):
    ref, port = ctx["ref"], ctx["port"]
    assert np.array_equal(ctx["r_sk"].coeffs, ctx["p_sk"].coeffs)
    for base in ("q", "qp", "bsk"):
        assert _eq(ctx["r_sk"].ntt_mont(getattr(ref, base)),
                   ctx["p_sk"].ntt_mont(getattr(port, base)))
    assert ctx["r_rk"].level == ctx["p_rk"].level
    assert _eq(ctx["r_rk"].ksk, ctx["p_rk"].ksk)
    # a reduced-level key draws and restricts identically too
    r_rng, p_rng = np.random.default_rng(3), np.random.default_rng(3)
    assert _eq(ref.gen_relin_key(ctx["r_sk"], r_rng, level=2).ksk,
               port.gen_relin_key(ctx["p_sk"], p_rng, level=2).ksk)
    # the reference's key arrays carry across
    carried = RelinKey.from_numpy(np.asarray(ctx["r_rk"].ksk), ctx["r_rk"].level, "cpu")
    assert _eq(ctx["r_rk"].ksk, carried.ksk)
    assert _eq(ctx["r_sk"].ntt_mont(ref.q), SecretKey(ctx["r_sk"].coeffs).ntt_mont(port.q))


def test_encode_decode_match(ctx):
    ref, port, slots = ctx["ref"], ctx["port"], ctx["slots"]
    pt = port.encode(slots)
    assert _eq(ref.encode(slots), pt)
    assert np.array_equal(to_u32(port.decode(pt)), slots)
    assert _eq(ref.lift_plaintext_ntt(ref.encode(slots), 2), port.lift_plaintext_ntt(pt, 2))


def test_encrypt_decrypt_match(ctx):
    ref, port = ctx["ref"], ctx["port"]
    assert _eq(ctx["r_ct"].data, ctx["p_ct"].data)
    got = port.decrypt_device(ctx["p_ct"], ctx["p_sk"])
    assert _eq(ref.decrypt_device(ctx["r_ct"], ctx["r_sk"]), got)
    assert np.array_equal(to_u32(port.decode(got)), ctx["slots"])
    # a reduced-level fresh ciphertext
    r_rng, p_rng = np.random.default_rng(4), np.random.default_rng(4)
    pt = ctx["slots"][0]
    assert _eq(ref.encrypt_symmetric(ref.encode(pt), ctx["r_sk"], r_rng, level=2).data,
               port.encrypt_symmetric(port.encode(pt), ctx["p_sk"], p_rng, level=2).data)


def test_multiply_relinearize_mod_switch_match(ctx):
    """operand_forms -> tensor_scaledown_fused -> relinearize -> mod_switch_to
    -> decrypt, the power wavefront's per-product chain."""
    ref, port = ctx["ref"], ctx["port"]
    lvl = ref.q.k
    r_d, p_d = ctx["r_ct"].data, ctx["p_ct"].data           # [2, 3, 2, L, N]
    r_fq, r_fb = jax.jit(lambda x: ref.operand_forms(x, lvl))(r_d)
    p_fq, p_fb = port.operand_forms(p_d, lvl)
    assert _eq(r_fq, p_fq) and _eq(r_fb, p_fb)
    r3 = jax.jit(lambda a, b, c, d: ref.tensor_scaledown_fused(a, b, c, d, lvl))(
        r_fq[0], r_fb[0], r_fq[1], r_fb[1])
    p3 = port.tensor_scaledown_fused(p_fq[0], p_fb[0], p_fq[1], p_fb[1], lvl)
    assert _eq(r3, p3)
    r_rel = ref.relinearize(RefCt(r3, is_ntt=False, level=lvl), ctx["r_rk"])
    p_rel = port.relinearize(Ciphertext(p3, is_ntt=False, level=lvl), ctx["p_rk"])
    assert _eq(r_rel.data, p_rel.data)
    r_sw, p_sw = ref.mod_switch_to(r_rel, 2), port.mod_switch_to(p_rel, 2)
    assert p_sw.level == r_sw.level == 2
    assert _eq(r_sw.data, p_sw.data)
    got = port.decode(port.decrypt_device(p_sw, ctx["p_sk"]))
    assert _eq(ref.decode(ref.decrypt_device(r_sw, ctx["r_sk"])), got)
    want = ctx["slots"][0].astype(np.uint64) * ctx["slots"][1] % ref.t
    assert np.array_equal(to_u32(got), want.astype(np.uint32))
    # relinearizing at a level below the key's
    r_low = ref.relinearize(ref.mod_switch_to(RefCt(r3, is_ntt=False, level=lvl), 2),
                            ctx["r_rk"])
    p_low = port.relinearize(port.mod_switch_to(Ciphertext(p3, is_ntt=False, level=lvl), 2),
                             ctx["p_rk"])
    assert _eq(r_low.data, p_low.data)


def test_multiply_sum_fused_matches(ctx):
    """premul_sum_rhs + multiply_sum_fused (the PS outer sum) over M = 3
    terms, lhs given in both its NTT-q and coefficient forms."""
    ref, port = ctx["ref"], ctx["port"]
    lvl, M = ref.q.k, 3
    r_d, p_d = ctx["r_ct"].data, ctx["p_ct"].data
    r_fbq, r_fbb = ref.premul_sum_rhs(RefCt(r_d[1], is_ntt=False, level=lvl), M)
    p_fbq, p_fbb = port.premul_sum_rhs(Ciphertext(p_d[1], is_ntt=False, level=lvl), M)
    assert _eq(r_fbq, p_fbq) and _eq(r_fbb, p_fbb)
    r_faq = ref.to_ntt(RefCt(r_d[0], is_ntt=False, level=lvl)).data
    p_faq = port.to_ntt(Ciphertext(p_d[0], is_ntt=False, level=lvl)).data
    assert _eq(r_faq, p_faq)
    r_tot = jax.jit(lambda a, x, b, c: ref.multiply_sum_fused(a, x, b, c, lvl, M))(
        r_faq, r_d[0], r_fbq, r_fbb)
    p_tot = port.multiply_sum_fused(p_faq, p_d[0], p_fbq, p_fbb, lvl, M)
    assert _eq(r_tot, p_tot)
    assert tuple(p_tot.shape) == (3, ref.q.k, ref.n)
    assert jnp.asarray(r_tot).dtype == jnp.uint32


# ---------------------------------------------------------------------------
# the rest of the BFV surface, one small-parameter ciphertext each (N=256,
# t=65537, 40/40-bit data primes and a 30-bit special prime)
# ---------------------------------------------------------------------------

SMALL = {
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}


@pytest.fixture(scope="module")
def small():
    ref = RefBfv(RefParams.from_dict(SMALL).seal_params)
    port = BfvContext(PSUParams.from_dict(SMALL).seal_params, device="cpu")
    r_rng, p_rng = np.random.default_rng(7), np.random.default_rng(7)
    r_sk, p_sk = ref.gen_secret_key(r_rng), port.gen_secret_key(p_rng)
    slots = np.random.default_rng(8).integers(0, ref.t, size=(3, ref.n), dtype=np.uint64)
    slots = slots.astype(np.uint32)
    r_ct = ref.encrypt_symmetric(ref.encode(slots), r_sk, r_rng)
    p_ct = port.encrypt_symmetric(port.encode(slots), p_sk, p_rng)
    assert _eq(r_ct.data, p_ct.data)
    return dict(ref=ref, port=port, r_sk=r_sk, p_sk=p_sk, slots=slots, r_ct=r_ct, p_ct=p_ct)


def _ct(cls, c, i, **kw):
    return cls(c.data[i], is_ntt=c.is_ntt, level=c.level, **kw)


def _op_case(op, ref, port, r_ct, p_ct, slots):
    """(reference value, port value, expected plaintext slots or None)."""
    lvl, t = ref.q.k, ref.t
    ra, rb = _ct(RefCt, r_ct, 0), _ct(RefCt, r_ct, 1)
    pa, pb = _ct(Ciphertext, p_ct, 0), _ct(Ciphertext, p_ct, 1)
    s0, s1 = slots[0].astype(np.uint64), slots[1].astype(np.uint64)
    if op == "add":
        return ref.add(ra, rb).data, port.add(pa, pb).data, (s0 + s1) % t
    if op == "add_ntt":
        return (ref.add(ref.to_ntt(ra), ref.to_ntt(rb)).data,
                port.add(port.to_ntt(pa), port.to_ntt(pb)).data, None)
    if op in ("add_plain", "add_plain_ntt"):
        pt = slots[2]
        if op == "add_plain":
            return (ref.add_plain(ra, ref.encode(pt)).data, port.add_plain(pa, port.encode(pt)).data,
                    (s0 + slots[2]) % t)
        return (ref.add_plain(ref.to_ntt(ra), ref.encode(pt)).data,
                port.add_plain(port.to_ntt(pa), port.encode(pt)).data, None)
    if op == "scale_plain":
        return ref.scale_plain(ref.encode(slots[2]), 2), port.scale_plain(port.encode(slots[2]), 2), None
    if op == "mul_plain_ntt":
        r_pt, p_pt = ref.lift_plaintext_ntt(ref.encode(slots[2])), port.lift_plaintext_ntt(port.encode(slots[2]))
        return (ref.mul_plain_ntt(ref.to_ntt(ra), r_pt).data,
                port.mul_plain_ntt(port.to_ntt(pa), p_pt).data, None)
    if op == "smul":
        from apsu_tpu.core.mod32 import shoup_mul as r_shoup
        from apsu_tpu.core.mod32 import shoup_pair as r_pair
        from apsu_tpu_torch.core.bfv import smul

        x, c = slots[2], 12345
        want = r_shoup(jnp.asarray(x), np.uint32(c), np.uint32(r_pair(c, t)), np.uint32(t))
        return want, smul(port.tensor(x), c, t), x.astype(np.uint64) * c % t
    if op in ("multiply", "square"):
        r3 = ref.square(ra) if op == "square" else ref.multiply(ra, rb)
        p3 = port.square(pa) if op == "square" else port.multiply(pa, pb)
        assert p3.size == 3 and p3.level == lvl
        want = s0 * (s0 if op == "square" else s1) % t
        return r3.data, p3.data, want
    if op == "multiply_sum":
        r3 = ref.multiply_sum(RefCt(r_ct.data[:2], False, lvl), RefCt(r_ct.data[1:], False, lvl))
        p3 = port.multiply_sum(Ciphertext(p_ct.data[:2], False, lvl),
                               Ciphertext(p_ct.data[1:], False, lvl))
        return r3.data, p3.data, (s0 * s1 + s1 * slots[2]) % t
    raise ValueError(op)


@pytest.mark.parametrize("op", ["add", "add_ntt", "add_plain", "add_plain_ntt", "scale_plain",
                                "mul_plain_ntt", "smul", "multiply", "square", "multiply_sum"])
def test_bfv_op_matches(small, op):
    """Each op's output tensor equals the reference's bit for bit; where the
    op has a plaintext meaning, the port's host decryption gives it."""
    ref, port = small["ref"], small["port"]
    r_val, p_val, want = _op_case(op, ref, port, small["r_ct"], small["p_ct"], small["slots"])
    assert _eq(r_val, p_val)
    if want is not None and op != "smul":
        ct = Ciphertext(p_val, is_ntt=False, level=ref.q.k)
        assert np.array_equal(to_u32(port.decode(port.decrypt(ct, small["p_sk"]))),
                              want.astype(np.uint32))
    elif op == "smul":
        assert np.array_equal(to_u32(p_val), want.astype(np.uint32))


def test_host_decrypt_noise_budget_and_q_at_match(small):
    """The host big-int decryption and the noise budget equal the
    reference's, on a fresh ciphertext and on a 3-component product."""
    ref, port = small["ref"], small["port"]
    lvl = ref.q.k
    assert port.Q_at(lvl) == ref.Q_at(lvl) and port.Q_at(1) == ref.Q_at(1)
    r3 = ref.multiply(_ct(RefCt, small["r_ct"], 0), _ct(RefCt, small["r_ct"], 1))
    p3 = port.multiply(_ct(Ciphertext, small["p_ct"], 0), _ct(Ciphertext, small["p_ct"], 1))
    for r_c, p_c in [(small["r_ct"], small["p_ct"]), (r3, p3)]:
        got = port.decrypt(p_c, small["p_sk"])
        assert np.array_equal(np.asarray(ref.decrypt(r_c, small["r_sk"])), got)
        assert np.array_equal(got, to_u32(port.decrypt_device(p_c, small["p_sk"])))
        budget = port.noise_budget(p_c, small["p_sk"])
        assert budget == ref.noise_budget(r_c, small["r_sk"]) and budget > 0
