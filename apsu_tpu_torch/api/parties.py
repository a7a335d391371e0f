"""The two parties and the query/response containers — port of
``apsu_tpu/api/parties.py``.

The *Sender* holds the small set: it cuckoo-hashes its items, replaces them
by slot-bound OPRF values, encrypts the source powers of its slot vectors and
finally decrypts the response.  The *Receiver* holds the large preprocessed
DB and evaluates the matching polynomials homomorphically (the
Paterson–Stockmeyer path or the plain dot product, by parameter set); on
a labeled DB its response also carries the blinded label results, which
``Sender.extract_labels`` decrypts.
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from apsu_tpu_torch.core.bfv import BfvContext, Ciphertext, RelinKey
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.measured_levels import defer_relin, powers_at_eval, query_level
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.device import synchronize
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.engine.evaluator import wavefront_work
from apsu_tpu_torch.engine.powers import plan_query
from apsu_tpu_torch.hash.cuckoo import CuckooTable, cuckoo_insert
from apsu_tpu_torch.hash.encoding import felts_from_items, items_from_felts
from apsu_tpu_torch.hash.items import LocFuncs
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.ops import ctr_mod
from apsu_tpu_torch.utils.stopwatch import GLOBAL, host_bytes


@dataclass
class QueryRequest:
    """Ciphertext batches for every source power + relinearization keys."""

    power_list: Tuple[int, ...]          # sorted source powers
    powers_data: torch.Tensor            # [P, B, 2, L, N] int32 ct data per power
    relin_key: Optional[torch.Tensor]    # [kdig, 2, Lqp, N] NTT mont or None
    # the public seeds the uniform components above expand from (the wire
    # then carries only c0 / ksk[:, 0] plus 32 bytes each)
    a_seed: Optional[bytes] = None
    rk_seed: Optional[bytes] = None


@dataclass
class QueryResponse:
    """All result packages of one query, batched."""

    results: torch.Tensor                # [B, C, 2, Le, N] coeff-domain ct
    eval_level: int
    label_results: Optional[torch.Tensor] = None  # labeled mode only, like results


def _default_rng(rng):
    return CsRng() if rng is None else rng


class Sender:
    """Query side (small set)."""

    def __init__(self, params: PSUParams, oprf, rng=None, loc_seed: bytes = b"apsu-loc",
                 oprf_factory=None, device="cuda"):
        """``oprf`` is an ``OprfBackend``, or None when ``oprf_factory`` is
        given: ``oprf_factory(cuckoo_table_items)`` builds the backend late,
        in ``create_query``, for the interactive OPRFs that bind the query
        party's cuckoo table at setup (KKRT, ECDH).  ``rng`` draws every party
        secret (secret key, relinearization-key seed and errors, query seed
        and encryption noise, OPRF state), in the reference's order: a
        ``numpy.random.Generator`` or a ``CsRng`` (the default, from OS
        entropy).  ``loc_seed`` seeds the cuckoo location functions; it must
        be the receiver DB's."""
        self.params = params
        self.oprf = oprf
        self.oprf_factory = oprf_factory
        self.bfv = BfvContext(params.seal_params, device=device)
        self.rng = _default_rng(rng)
        self.sk = self.bfv.gen_secret_key(self.rng)
        self.query_lvl = query_level(params, len(self.bfv.q_primes))
        qp = params.query_params
        needs_relin = bool(
            plan_query(qp.query_powers, params.table_params.max_items_per_bin,
                       qp.ps_low_degree).low.levels
        ) or qp.ps_low_degree > 0
        self.rk_seed = bytes(self.rng.bytes(32)) if needs_relin else None
        self.rk = (
            self.bfv.gen_relin_key(self.sk, self.rng, a_seed=self.rk_seed, level=self.query_lvl)
            if needs_relin else None
        )
        tp = params.table_params
        self.locs = LocFuncs(tp.table_size, tp.hash_func_count, loc_seed)
        self.cuckoo: Optional[CuckooTable] = None

    def create_query(self, items: np.ndarray) -> QueryRequest:
        """items: [n, 2] uint64 hashed items -> encrypted query powers."""
        with GLOBAL.span("create_query"):
            return self._create_query(items)

    def _create_query(self, items: np.ndarray) -> QueryRequest:
        p = self.params
        tp = p.table_params
        with GLOBAL.span("cuckoo"):
            self.cuckoo = cuckoo_insert(items, tp.table_size, tp.hash_func_count,
                                        locs=self.locs)
        with GLOBAL.span("oprf"):
            if self.oprf_factory is not None:
                self.oprf = self.oprf_factory(self.cuckoo.table)
            slots = np.arange(tp.table_size, dtype=np.int64)
            prf = self.oprf.eval(self.cuckoo.table, slots)
            felts = felts_from_items(prf, p.felts_per_item, p.item_bit_count_per_felt)

        with GLOBAL.span("encode"):
            # slot vector per bundle index: lane (s % ipb)·fpi + f = felt f of slot s
            B, N = p.bundle_idx_count, p.poly_degree
            ipb, fpi = p.items_per_bundle, p.felts_per_item
            qvec = np.zeros((B, N), dtype=np.uint32)
            b = slots // ipb
            lane = (slots % ipb) * fpi
            for f in range(fpi):
                qvec[b, lane + f] = felts[:, f]

            # plaintext powers of the query vector, encoded and encrypted as
            # one [P, B, N] batch
            t = p.seal_params.plain_modulus
            plist = tuple(p.query_params.query_powers)
            stack = np.stack(
                [_pow_mod(qvec.astype(np.uint64), s, t).astype(np.uint32) for s in plist]
            )
            pt = self.bfv.encode(stack)
        with GLOBAL.span("encrypt"):
            a_seed = bytes(self.rng.bytes(32))
            ct = self.bfv.encrypt_symmetric(pt, self.sk, self.rng, a_seed=a_seed,
                                            level=self.query_lvl)  # [P, B, 2, L, N]
        return QueryRequest(
            power_list=plist,
            powers_data=ct.data,
            relin_key=self.rk.ksk if self.rk else None,
            a_seed=a_seed,
            rk_seed=self.rk_seed,
        )

    def extract_matrix(self, resp: QueryResponse) -> np.ndarray:
        """Decrypt the response -> slot-value matrix [B, C, N] mod t (one
        transfer to the host at the end)."""
        ct = Ciphertext(self.bfv.tensor(resp.results), is_ntt=False, level=resp.eval_level)
        return to_u32(self.bfv.decode(self.bfv.decrypt_device(ct, self.sk)))

    def peqt_matrix(self, slot_matrix: np.ndarray) -> np.ndarray:
        """[B, C, N] -> per-item felt blocks [C, table_size, fpi]."""
        return _slots_to_item_blocks(self.params, slot_matrix)

    def extract_labels(self, resp: QueryResponse) -> np.ndarray:
        """Labeled mode: decrypt the label results -> per-slot 16-byte label
        candidates [C, table_size, 16] uint8.  Row (c, slot) holds the true
        label exactly where that cache's matching result equals the mask
        (elsewhere the ρ·M(x) blinding makes it garbage)."""
        if resp.label_results is None:
            raise ValueError("response carries no label results")
        ct = Ciphertext(self.bfv.tensor(resp.label_results), is_ntt=False,
                        level=resp.eval_level)
        slot_matrix = to_u32(self.bfv.decode(self.bfv.decrypt_device(ct, self.sk)))
        blocks = _slots_to_item_blocks(self.params, slot_matrix)   # [C, S, fpi]
        C, S, fpi = blocks.shape
        items = items_from_felts(blocks.reshape(C * S, fpi).astype(np.uint32),
                                 self.params.item_bit_count_per_felt)
        return items.view(np.uint8).reshape(C, S, 16)


class Receiver:
    """DB side (large set)."""

    def __init__(self, params: PSUParams, db: ReceiverDB, rng=None):
        """rng draws the result masks: a ``numpy.random.Generator`` or a
        ``CsRng`` (the default, from OS entropy).  A ``CsRng``'s masks are
        made where the DB lies (``_draw``), the same bits either way."""
        self.params = params
        self.db = db
        self.bfv = db.bfv
        self.rng = _default_rng(rng)
        self.query_lvl = query_level(params, len(self.bfv.q_primes))
        self.plan = plan_query(
            params.query_params.query_powers,
            params.table_params.max_items_per_bin,
            params.query_params.ps_low_degree,
        )
        self._wavefront = wavefront_work(self.plan)   # (products a bundle, groups)
        self._draws: Optional[ctr_mod.KeyStream] = None   # a CsRng's, where the DB lies
        self._last_mask: Optional[np.ndarray] = None      # in host memory
        self._mask_done = None   # a card mask's event after its copy to the host
        self._ordinals = itertools.count()   # each query's id in the spans

    @property
    def last_mask(self) -> Optional[np.ndarray]:
        """The last query's mask [B, C, N] uint32 in host memory; a mask drawn
        on the card is its copy, queued behind the draw, waited for here."""
        if self._last_mask is None:
            return None
        if self._mask_done is not None:
            self._mask_done.synchronize()
        return self._last_mask

    def validate_query(self, req: QueryRequest) -> None:
        """Source powers must match the parameter set, ciphertext batches
        must cover every bundle index, relin keys must be present iff needed."""
        p = self.params
        expected = tuple(p.query_params.query_powers)
        if tuple(req.power_list) != expected:
            raise ValueError(f"query powers {req.power_list} != parameter powers {expected}")
        P, B = req.powers_data.shape[0], req.powers_data.shape[1]
        expected_B = self.db.coeff_cache.shape[0]
        if P != len(expected) or B != expected_B:
            raise ValueError(
                f"power tensor {tuple(req.powers_data.shape)} inconsistent with "
                f"{len(expected)} powers × {expected_B} bundle indices"
            )
        if req.powers_data.shape[-1] != p.poly_degree:
            raise ValueError("ciphertext degree mismatch")
        if req.powers_data.shape[-2] != self.query_lvl:
            raise ValueError(
                f"query ciphertexts carry {req.powers_data.shape[-2]} limbs; "
                f"this parameter set encrypts at level {self.query_lvl}"
            )
        needs_relin = (
            bool(self.plan.low.levels)
            or (self.plan.high is not None and bool(self.plan.high.levels))
            or self.plan.uses_ps
        )
        if needs_relin and req.relin_key is None:
            raise ValueError("query requires relinearization keys")

    def _draw(self, lo: int, span: int, shape, keep: bool = False) -> tuple:
        """``rng.integers(lo, lo + span, size=shape)`` as an int32 tensor, and
        with ``keep`` its uint32 copy in host memory (else None).  A ``CsRng``
        reserves the words' bytes and ``ops/ctr_mod.py`` makes them on the
        DB's device (the kernel on a card, which also queues the kept copy);
        any other rng draws on the host.  Either way the bits and the stream
        are the rng's own."""
        if isinstance(self.rng, CsRng):
            key, counter, offset = self.rng.reserve(8 * math.prod(shape))
            if self._draws is None or self._draws.key is not key:
                self._draws = ctr_mod.KeyStream(key, self.bfv.device)
            return self._draws.draw(counter, offset, lo, span, shape, keep)
        x = self.rng.integers(lo, lo + span, size=shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(x.view(np.int32)), (x if keep else None)

    def _prepare(self, req: QueryRequest):
        """Validate ``req`` and draw the query's mask [B, C, N] as int32 on
        the DB's device for a ``CsRng``, in host memory otherwise (kept as
        ``last_mask``).  Returns (source ciphertexts, relinearization key or
        None, mask)."""
        ql = self.query_lvl
        with GLOBAL.span("prepare.validate"):
            self.validate_query(req)
        with GLOBAL.span("prepare.upload", nbytes=host_bytes(req.powers_data, req.relin_key)):
            data = self.bfv.tensor(req.powers_data)
            ksk = self.bfv.tensor(req.relin_key) if req.relin_key is not None else None
        cts = {
            s: Ciphertext(data[i], is_ntt=False, level=ql)
            for i, s in enumerate(req.power_list)
        }
        rk = RelinKey(ksk, ql) if ksk is not None else None
        B, C = self.db.coeff_cache.shape[0], self.db.coeff_cache.shape[1]
        t = self.params.seal_params.plain_modulus
        with GLOBAL.span("prepare.mask"):
            mask, self._last_mask = self._draw(0, t, (B, C, self.params.poly_degree), keep=True)
        self._mask_done = self._draws.done if mask.is_cuda else None
        GLOBAL.count("prepare.mask.words", mask.numel())
        if mask.is_cuda:
            GLOBAL.count("prepare.mask.device", 1)
        return cts, rk, mask

    def run_query(self, req: QueryRequest, timings: Optional[dict] = None) -> QueryResponse:
        """Evaluate one query as two programs (``engine/programs.py``): the
        power tensors, then the evaluation.  ``timings``: pass a dict to get
        an in-call phase split {"powers_s", "eval_s"} (a device sync is
        inserted between the two).  On a labeled DB the label blinding ρ is
        drawn from ``rng`` after the mask.  The query's spans carry the next
        ordinal of this receiver as their query id (``utils/stopwatch.py``),
        and so do those that follow until the next query, such as the
        response's copy to the host.  The counters ``powers.products`` and
        ``powers.groups`` gain the power wavefront's ciphertext products
        (over every bundle) and batched multiply + relinearize calls, from
        the plan (``engine/evaluator.py:wavefront_work``)."""
        GLOBAL.query = next(self._ordinals)
        with GLOBAL.span("query"):
            return self._run_query(req, timings)

    def _run_query(self, req: QueryRequest, timings: Optional[dict]) -> QueryResponse:
        p = self.params
        db, bfv, ql = self.db, self.bfv, self.query_lvl
        cts, rk, mask = self._prepare(req)
        B, C, N = mask.shape
        t = p.seal_params.plain_modulus
        datas = [cts[s].data for s in req.power_list]
        ksk = rk.ksk if rk is not None else None

        label_results = None
        t0 = time.perf_counter()
        with GLOBAL.span("program.powers"):
            GLOBAL.count("powers.products", self._wavefront[0] * B)
            GLOBAL.count("powers.groups", self._wavefront[1])
            if self.plan.uses_ps:
                low_ntt, high_coeff = programs.ps_power_tensors(
                    bfv, datas, req.power_list, ql, self.plan, ksk, db.eval_lvl,
                    at_eval=powers_at_eval(p), defer_relin=defer_relin(p))
                last = high_coeff
            else:
                powers = programs.power_tensor(bfv, datas, req.power_list, ql, self.plan.low,
                                               ksk, db.eval_lvl, at_eval=powers_at_eval(p))
                last = powers
        if timings is not None:
            synchronize(last)
            timings["powers_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        with GLOBAL.span("program.eval"):
            if self.plan.uses_ps:
                res = programs.ps_matching(
                    bfv, low_ntt, high_coeff, db.coeff_cache, db.ps_const_polys, mask, ksk,
                    ql, p.query_params.ps_low_degree, db.result_lvl,
                    p.table_params.max_items_per_bin, eval_level=db.eval_lvl)
                level = db.result_lvl
            elif db.label_cache is not None:
                rho = self._draw(1, t - 1, (B, C, N))[0]
                res, label_results = programs.matching_labeled(
                    bfv, powers, db.coeff_cache, db.const_slots, mask, db.label_cache,
                    db.label0_slots, rho, db.eval_lvl)
                level = db.eval_lvl
            else:
                res = programs.matching(bfv, powers, db.coeff_cache, db.const_slots, mask,
                                        db.eval_lvl)
                level = db.eval_lvl
        if timings is not None:
            synchronize(res)
            timings["eval_s"] = time.perf_counter() - t0
        return QueryResponse(results=res, eval_level=level, label_results=label_results)

    def peqt_matrix(self) -> np.ndarray:
        """The last query's mask in per-item felt-block form [C, table_size, fpi]."""
        return _slots_to_item_blocks(self.params, self.last_mask)


def _pow_mod(base: np.ndarray, e: int, m: int) -> np.ndarray:
    """Vectorized square-and-multiply (values < 2^32, m < 2^31: uint64-safe)."""
    result = np.ones_like(base)
    b = base % np.uint64(m)
    while e:
        if e & 1:
            result = result * b % np.uint64(m)
        b = b * b % np.uint64(m)
        e >>= 1
    return result


def _slots_to_item_blocks(params: PSUParams, slot_matrix: np.ndarray) -> np.ndarray:
    """[B, C, N] slot values -> [C, table_size, fpi] per-item felt blocks."""
    p = params
    tp = p.table_params
    ipb, fpi = p.items_per_bundle, p.felts_per_item
    slots = np.arange(tp.table_size)
    b = slots // ipb
    lane = (slots % ipb) * fpi
    C = slot_matrix.shape[1]
    out = np.empty((C, tp.table_size, fpi), dtype=slot_matrix.dtype)
    for f in range(fpi):
        out[:, :, f] = slot_matrix[b, :, lane + f].T
    return out
