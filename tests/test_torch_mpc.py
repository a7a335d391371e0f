"""The port's MPC stack against the JAX package's, exactly: for each protocol
the same seeds go through the reference parties and the port's parties, and
both their outputs and their transcripts (every frame, in each direction,
captured by a recording duplex pair) must be equal.  Each protocol also runs
with one reference party against one port party over one duplex pair, each
side encoding and decoding frames with its own package, and must give the
reference's outputs and transcript.

Covered: the frame codec, Chou–Orlandi base OT, IKNP (m=512), SoftSpoken
(m=4096, k=4), silent OT at its smallest LPN size, chosen and one-sided OT,
KKRT, the ECDH OPRF, the DDH PEQT, Beneš routing of random permutations, OSN
share translation, the OSN PEQT, and the union and CARDSUM endgames.  The
port builds its native libraries with g++ from its own sources."""

import queue
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

import apsu_tpu.mpc.baseot as r_baseot
import apsu_tpu.mpc.duplex as r_duplex
import apsu_tpu.mpc.endgame as r_endgame
import apsu_tpu.mpc.kkrt as r_kkrt
import apsu_tpu.mpc.oprf as r_oprf
import apsu_tpu.mpc.osn as r_osn
import apsu_tpu.mpc.osn_peqt as r_osn_peqt
import apsu_tpu.mpc.otext as r_otext
import apsu_tpu.mpc.peqt as r_peqt
import apsu_tpu.mpc.prg as r_prg
import apsu_tpu.mpc.silent as r_silent
import apsu_tpu_torch.mpc.baseot as p_baseot
import apsu_tpu_torch.mpc.duplex as p_duplex
import apsu_tpu_torch.mpc.endgame as p_endgame
import apsu_tpu_torch.mpc.kkrt as p_kkrt
import apsu_tpu_torch.mpc.oprf as p_oprf
import apsu_tpu_torch.mpc.osn as p_osn
import apsu_tpu_torch.mpc.osn_peqt as p_osn_peqt
import apsu_tpu_torch.mpc.otext as p_otext
import apsu_tpu_torch.mpc.peqt as p_peqt
import apsu_tpu_torch.mpc.prg as p_prg
import apsu_tpu_torch.mpc.silent as p_silent

REF = dict(baseot=r_baseot, duplex=r_duplex, endgame=r_endgame, kkrt=r_kkrt, oprf=r_oprf,
           osn=r_osn, osn_peqt=r_osn_peqt, otext=r_otext, peqt=r_peqt, prg=r_prg,
           silent=r_silent)
PORT = dict(baseot=p_baseot, duplex=p_duplex, endgame=p_endgame, kkrt=p_kkrt, oprf=p_oprf,
            osn=p_osn, osn_peqt=p_osn_peqt, otext=p_otext, peqt=p_peqt, prg=p_prg,
            silent=p_silent)
JOIN_S = 120


class RecordingQueue(queue.Queue):
    """A duplex direction that keeps every encoded frame put on it."""

    def __init__(self):
        super().__init__()
        self.frames = []

    def put(self, item, *args, **kwargs):
        self.frames.append(bytes(item))
        super().put(item, *args, **kwargs)


def run_pair(side_a, side_b):
    """Run two protocol roles, each ``(package, fn(ch))``, on a recording
    duplex pair whose ends use their own package's QueueDuplex.  Returns
    (result a, result b, (frames a→b, frames b→a))."""
    (pkg_a, fa), (pkg_b, fb) = side_a, side_b
    ab, ba = RecordingQueue(), RecordingQueue()
    ca, cb = pkg_a["duplex"].QueueDuplex(ab, ba), pkg_b["duplex"].QueueDuplex(ba, ab)
    out, err = {}, []

    def wrap(name, fn, ch):
        try:
            out[name] = fn(ch)
        except Exception as e:  # reported below
            err.append(e)

    threads = [threading.Thread(target=wrap, args=("a", fa, ca), daemon=True),
               threading.Thread(target=wrap, args=("b", fb, cb), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a protocol party hung"
    if err:
        raise err[0]
    return out["a"], out["b"], (ab.frames, ba.frames)


def assert_same(a, b, path="out"):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, a.dtype, b)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# the protocols: each returns (role a, role b), a role being pkg -> fn(ch)
# ---------------------------------------------------------------------------

def _rng(pkg, tag):
    """The same CsRng stream in either package."""
    return pkg["prg"].CsRng(b"test_torch_mpc/" + tag.encode())


def _bits(n, seed=3):
    return np.random.default_rng(seed).integers(0, 2, size=n).astype(np.uint8)


def _msgs(m, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(m, w), dtype=np.uint8),
            rng.integers(0, 256, size=(m, w), dtype=np.uint8))


def _peqt_mats(C=3, S=40, cols=(0, 5, 17, 39)):
    rng = np.random.default_rng(0)
    qm = rng.integers(0, 256, size=(C, S, 16), dtype=np.uint8)
    dm = rng.integers(0, 256, size=(C, S, 16), dtype=np.uint8)
    for j in cols:
        c = rng.integers(0, C)
        dm[c, j] = qm[c, j]
    return qm, dm


def _kkrt_inputs(n=128):
    return np.random.default_rng(0).integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)


def _kkrt_sender(pkg, ch):
    s = pkg["kkrt"].KkrtSender(ch, 128, np.random.default_rng(1))
    probe = np.random.default_rng(9).integers(0, 1 << 64, size=(128, 2), dtype=np.uint64)
    slots = np.arange(128)
    return s.q_cols, s.s_pack, s.eval(_kkrt_inputs(), slots), s.eval(probe, slots)


def _kkrt_receiver(pkg, ch):
    r = pkg["kkrt"].KkrtReceiver(ch, _kkrt_inputs(), np.random.default_rng(2))
    return r.eval(_kkrt_inputs(), np.arange(128))


def _ecdh_server(pkg, ch):
    srv = pkg["oprf"].EcdhOprfServer(_rng(pkg, "ecdh-server"))
    ch.send(srv.serve_round(ch.recv()))
    items = _kkrt_inputs(40)
    return srv.eval(items, np.arange(40) * 3)


def _ecdh_client(pkg, ch):
    cli = pkg["oprf"].EcdhOprfClient(ch, _kkrt_inputs(40), _rng(pkg, "ecdh-client"))
    return cli.eval(_kkrt_inputs(40), np.arange(40))


def _endgame_query(pkg, ch, mode, peqt):
    qm, _ = _peqt_mats(C=2, S=48, cols=(1, 9, 30))
    rng = np.random.default_rng(4)
    filled = rng.integers(0, 4, size=48) > 0
    if mode == "union":
        payload = rng.integers(0, 256, size=(48, 16), dtype=np.uint8)
        return pkg["endgame"].endgame_query_side(ch, qm, payload, filled,
                                                 _rng(pkg, "eg-q"), peqt=peqt)
    values = rng.integers(0, 1 << 40, size=48).astype(np.uint64)
    return pkg["endgame"].cardsum_query_side(ch, qm, values, filled,
                                             _rng(pkg, "eg-q"), peqt=peqt)


def _endgame_db(pkg, ch, mode, peqt):
    _, dm = _peqt_mats(C=2, S=48, cols=(1, 9, 30))
    side = pkg["endgame"].endgame_db_side if mode == "union" else pkg["endgame"].cardsum_db_side
    return side(ch, dm, _rng(pkg, "eg-db"), peqt=peqt)


PROTOCOLS = {
    "base_ot": (lambda pkg: lambda ch: pkg["baseot"].base_ot_send(ch, 64, np.random.default_rng(1)),
                lambda pkg: lambda ch: pkg["baseot"].base_ot_recv(ch, _bits(64),
                                                                  np.random.default_rng(2))),
    "iknp_512": (lambda pkg: lambda ch: pkg["otext"].iknp_send(ch, 512, np.random.default_rng(1)),
                 lambda pkg: lambda ch: pkg["otext"].iknp_recv(ch, _bits(512),
                                                               np.random.default_rng(2))),
    "softspoken_4096": (
        lambda pkg: lambda ch: pkg["otext"].ot_ext_send(ch, 4096, _rng(pkg, "ss-s")),
        lambda pkg: lambda ch: pkg["otext"].ot_ext_recv(ch, _bits(4096), _rng(pkg, "ss-r"))),
    "silent_smallest": (
        lambda pkg: lambda ch: pkg["silent"].silent_send(ch, 3000, np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["silent"].silent_recv(ch, _bits(3000),
                                                         np.random.default_rng(2))),
    "chosen_ot": (
        lambda pkg: lambda ch: pkg["otext"].ot_send_chosen(ch, *_msgs(300, 40),
                                                           np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["otext"].ot_recv_chosen(ch, _bits(300),
                                                           np.random.default_rng(2))),
    "onesided_ot": (
        lambda pkg: lambda ch: pkg["otext"].ot_send_onesided(ch, _msgs(200)[1],
                                                             np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["otext"].ot_recv_onesided(ch, _bits(200),
                                                             np.random.default_rng(2))),
    "kkrt": (lambda pkg: lambda ch: _kkrt_sender(pkg, ch),
             lambda pkg: lambda ch: _kkrt_receiver(pkg, ch)),
    "ecdh_oprf": (lambda pkg: lambda ch: _ecdh_server(pkg, ch),
                  lambda pkg: lambda ch: _ecdh_client(pkg, ch)),
    "ddh_peqt": (
        lambda pkg: lambda ch: pkg["peqt"].ddh_peqt_sender(ch, _peqt_mats()[0],
                                                           np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["peqt"].ddh_peqt_receiver(ch, _peqt_mats()[1],
                                                             np.random.default_rng(2))),
    "osn_37": (
        lambda pkg: lambda ch: pkg["osn"].osn_programmer(
            ch, np.random.default_rng(5).permutation(37), np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["osn"].osn_holder(ch, _msgs(37)[0], np.random.default_rng(2))),
    "osn_peqt": (
        lambda pkg: lambda ch: pkg["osn_peqt"].osn_peqt_query_side(ch, _peqt_mats()[0],
                                                                   np.random.default_rng(1)),
        lambda pkg: lambda ch: pkg["osn_peqt"].osn_peqt_db_side(ch, _peqt_mats()[1],
                                                                np.random.default_rng(2))),
    "union_endgame_ddh": (lambda pkg: lambda ch: _endgame_query(pkg, ch, "union", "ddh"),
                          lambda pkg: lambda ch: _endgame_db(pkg, ch, "union", "ddh")),
    "union_endgame_osn": (lambda pkg: lambda ch: _endgame_query(pkg, ch, "union", "osn"),
                          lambda pkg: lambda ch: _endgame_db(pkg, ch, "union", "osn")),
    "cardsum_endgame_ddh": (lambda pkg: lambda ch: _endgame_query(pkg, ch, "cardsum", "ddh"),
                            lambda pkg: lambda ch: _endgame_db(pkg, ch, "cardsum", "ddh")),
}


@lru_cache(maxsize=None)
def reference_run(name):
    role_a, role_b = PROTOCOLS[name]
    return run_pair((REF, role_a(REF)), (REF, role_b(REF)))


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_port_protocol_matches_reference(name):
    """Port against port: the reference's outputs and transcript."""
    role_a, role_b = PROTOCOLS[name]
    got = run_pair((PORT, role_a(PORT)), (PORT, role_b(PORT)))
    want = reference_run(name)
    assert_same(want[:2], got[:2])
    assert [len(d) for d in got[2]] == [len(d) for d in want[2]]
    assert got[2] == want[2], "transcripts differ"


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_reference_party_against_port_party(name):
    """One reference party against one port party: each role once from
    each package, exact."""
    role_a, role_b = PROTOCOLS[name]
    want = reference_run(name)
    for side_a, side_b in [((REF, role_a(REF)), (PORT, role_b(PORT))),
                           ((PORT, role_a(PORT)), (REF, role_b(REF)))]:
        got = run_pair(side_a, side_b)
        assert_same(want[:2], got[:2])
        assert got[2] == want[2], "transcripts differ"


def test_protocol_outputs_are_right():
    """The functionalities themselves, on the port's runs: chosen OT hands
    over the chosen messages, OSN shares add up to the permuted values, the
    PEQTs find the planted columns, the endgames transfer what they should."""
    got = {name: run_pair((PORT, a(PORT)), (PORT, b(PORT)))
           for name, (a, b) in PROTOCOLS.items()
           if name in ("chosen_ot", "osn_37", "ddh_peqt", "osn_peqt", "kkrt")}
    m0, m1 = _msgs(300, 40)
    want = np.where(_bits(300)[:, None].astype(bool), m1, m0)
    assert np.array_equal(got["chosen_ot"][1], want)
    perm = np.random.default_rng(5).permutation(37)
    assert np.array_equal(got["osn_37"][0] ^ got["osn_37"][1], _msgs(37)[0][perm])
    for name in ("ddh_peqt", "osn_peqt"):
        perm, matched = got[name][:2]
        assert np.array_equal(matched, np.isin(perm, (0, 5, 17, 39)))
    q_cols, s_pack, sender_eval, other = got["kkrt"][0]
    assert np.array_equal(sender_eval, got["kkrt"][1])
    assert not np.any(np.all(other == sender_eval, axis=1))


def test_frame_codec_matches_reference():
    rng = np.random.default_rng(0)
    objs = [b"", b"\x00abc", bytearray(b"xyz"), np.arange(7, dtype=np.uint8),
            rng.integers(0, 1 << 32, size=(3, 4, 5), dtype=np.uint32),
            rng.integers(-(1 << 62), 1 << 62, size=(2, 3), dtype=np.int64),
            np.zeros((0, 16), np.uint64), np.array(5, np.int32),
            np.asfortranarray(rng.integers(0, 9, size=(4, 6), dtype=np.int32))]
    for obj in objs:
        enc = p_duplex._encode(obj)
        assert enc == r_duplex._encode(obj)
        for dec in (p_duplex._decode(enc), r_duplex._decode(enc)):
            if isinstance(obj, (bytes, bytearray)):
                assert dec == bytes(obj)
            else:  # a 0-d array travels with shape (1,), as in the reference
                want = np.ascontiguousarray(obj)
                assert dec.dtype == want.dtype and dec.shape == want.shape
                assert np.array_equal(dec, want)
    with pytest.raises(TypeError):
        p_duplex._encode(np.zeros(3, np.float32))


def test_benes_routing_matches_reference():
    """Topology and switch settings of the port's own router build equal the
    reference's for random permutations, and realise each permutation."""
    rng = np.random.default_rng(0)
    for n in list(range(2, 24)) + [64, 100, 409, 819]:
        cnt, levels = p_osn.benes_topology(n)
        r_cnt, r_levels = r_osn.benes_topology(n)
        assert cnt == r_cnt
        assert_same([list(lv) for lv in levels], [list(lv) for lv in r_levels])
        for _ in range(3):
            perm = rng.permutation(n).astype(np.int64)
            settings = p_osn.benes_route(perm)
            assert np.array_equal(settings, r_osn.benes_route(perm))
            v = np.arange(n)
            for a, b, idx in levels:
                sw = settings[idx].astype(bool)
                va, vb = v[a].copy(), v[b].copy()
                v[a] = np.where(sw, vb, va)
                v[b] = np.where(sw, va, vb)
            assert np.array_equal(v, perm)
    with pytest.raises(ValueError):
        p_osn.benes_route(np.array([0, 0, 1]))


def test_prg_and_ec_match_reference():
    blocks = np.random.default_rng(1).integers(0, 256, size=(33, 16), dtype=np.uint8)
    assert np.array_equal(p_prg.prg_bits(b"seed", 77), r_prg.prg_bits(b"seed", 77))
    assert np.array_equal(p_prg.aes_ecb_fixed(blocks), r_prg.aes_ecb_fixed(blocks))
    for tweak in (0, 5, 0xE101):
        assert np.array_equal(p_prg.mmo_hash(blocks, tweak), r_prg.mmo_hash(blocks, tweak))
    assert np.array_equal(p_prg.mmo_hash_indexed(blocks), r_prg.mmo_hash_indexed(blocks))
    assert np.array_equal(p_prg.aes_code(blocks, 4), r_prg.aes_code(blocks, 4))
    bits = np.random.default_rng(2).integers(0, 2, size=(5, 21), dtype=np.uint8)
    packed = p_prg.pack_bits_rows(bits)
    assert np.array_equal(packed, r_prg.pack_bits_rows(bits))
    assert np.array_equal(p_prg.unpack_bits_rows(packed, 21), bits)

    from apsu_tpu.mpc import ec as r_ec
    from apsu_tpu_torch.mpc import ec as p_ec

    scalars = p_ec.random_scalars(6, np.random.default_rng(3))
    sb = p_ec.scalars_to_bytes(scalars)
    assert np.array_equal(sb, r_ec.scalars_to_bytes(scalars))
    pts = p_ec.base_mult(sb)
    assert np.array_equal(pts, r_ec.base_mult(sb))
    seeds = np.random.default_rng(4).integers(0, 256, size=(6, 32), dtype=np.uint8)
    hp = p_ec.hash_to_point(seeds)
    assert np.array_equal(hp, r_ec.hash_to_point(seeds))
    assert np.array_equal(p_ec.scalar_mult(hp, sb), r_ec.scalar_mult(hp, sb))
    assert np.array_equal(p_ec.point_add(pts, hp), r_ec.point_add(pts, hp))
    assert np.array_equal(p_ec.point_sub(pts, hp), r_ec.point_sub(pts, hp))
    assert np.array_equal(p_ec.point_sub(p_ec.point_add(pts, hp), hp), pts)


def test_native_libraries_build_from_the_port_sources(tmp_path):
    """Both host libraries are compiled from apsu_tpu_torch/mpc/native into
    apsu_tpu_torch/_build/<hash>/ (nothing is committed there), and a
    source that does not compile raises."""
    from apsu_tpu_torch.ops import _build

    native = Path(p_osn.__file__).parent / "native"
    for src in (native / "ec25519.cpp", native / "benes.cpp"):
        lib = _build.build_host(src)
        assert lib.parent.parent == _build.BUILD_ROOT and lib.name == f"lib{src.stem}.so"
        assert lib.exists() and _build.build_host(src) == lib
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        _build.build_host(broken)
