"""A cell's inputs, made from ``--seed``: the receiver's DB and the pool of
requests, with what the reference needs to judge the responses (the roots or
items, each sender's secret key and items or query values).

Every draw comes from a stream keyed by (seed, purpose), so one seed gives
the same inputs in every run.  Bulk data is drawn on the device with a
``torch.Generator``; the program only ever receives the finished inputs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# the purposes of the seed's streams
ROOTS, PLANT, SENDER, RECEIVER_ITEMS = 1, 2, 3, 4


def stream(seed: int, purpose: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed), purpose, index])


def device_generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(stream(seed, purpose).integers(0, 1 << 63)))
    return g


def receiver_key(seed: int) -> bytes:
    """The key of the receiver's mask RNG, as the receiver CLI keys a seeded
    run: sha256 of ``apsu-cli-seed:<seed>``."""
    return hashlib.sha256(b"apsu-cli-seed:%d" % int(seed)).digest()


@dataclass
class Inputs:
    """What the reference reads: the receiver's mask key, the DB's roots
    (dense) or items, and per pool request its secret key and its query
    values (dense) or items."""

    mask_key: bytes
    roots: Optional[np.ndarray] = None        # [B, C, K, N] uint32, dense DBs
    db_items: Optional[np.ndarray] = None     # [n, 2] uint64, item DBs
    secrets: list = field(default_factory=list)        # [N] int8 ternary
    query_values: list = field(default_factory=list)   # [B, N] uint32 (dense)
    query_items: list = field(default_factory=list)    # [m, 2] uint64 (items)


def load_params(cfg: dict):
    from apsu_tpu_torch.core.params import PSUParams

    return PSUParams.from_dict(cfg["params"])


def check_moduli(cfg: dict, params) -> None:
    """The program must run on the moduli the configuration states."""
    sp = params.seal_params
    got = {"data": list(sp.data_modulus), "special": sp.special_modulus,
           "plain": sp.plain_modulus}
    if got != cfg["moduli"]:
        raise SystemExit(f"moduli {got} differ from the configuration's {cfg['moduli']}")


def _distinct_items(rng: np.random.Generator, n: int) -> np.ndarray:
    items = rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)
    if len(np.unique(items, axis=0)) != n:
        raise SystemExit("the seed drew a repeated 128-bit item")
    return items


def _pow_mod(x: np.ndarray, e: int, t: int) -> np.ndarray:
    out = np.ones_like(x, dtype=np.int64)
    b = x.astype(np.int64) % t
    while e:
        if e & 1:
            out = out * b % t
        b = b * b % t
        e >>= 1
    return out


class _Given:
    """Hands ``set_synthetic_dense`` the roots the harness drew."""

    def __init__(self, roots: np.ndarray):
        self.roots = roots

    def integers(self, low, high, size=None, dtype=None):
        if tuple(size) != self.roots.shape:
            raise SystemExit(f"the DB asked for roots {size}, the harness drew {self.roots.shape}")
        return self.roots


def build_db(cfg: dict, params, seed: int, device, inputs: Inputs):
    """The receiver's DB on ``device``.  ``dense``: every bin full, roots
    drawn on the device from the seed (returned, for the planted queries);
    ``items``: ``set_data`` over distinct 128-bit items drawn from the seed."""
    from apsu_tpu_torch.db.receiver_db import ReceiverDB

    db_cfg = cfg["db"]
    loc_seed = cfg["loc_seed"].encode()
    if db_cfg["kind"] == "dense":
        B, N = params.bundle_idx_count, params.poly_degree
        K, C = params.table_params.max_items_per_bin, db_cfg["caches"]
        t = params.seal_params.plain_modulus
        g = device_generator(seed, ROOTS, device)
        roots_dev = torch.randint(1, t, (B, C, K, N), generator=g, dtype=torch.int32,
                                  device=device)
        inputs.roots = roots_dev.cpu().numpy().view(np.uint32)
        db = ReceiverDB(params, loc_seed=loc_seed, device=device)
        db.set_synthetic_dense(_Given(inputs.roots), n_caches=C)
        return db, roots_dev
    if db_cfg["kind"] == "items":
        from apsu_tpu_torch.mpc.oprf import DebugOprf

        inputs.db_items = _distinct_items(stream(seed, RECEIVER_ITEMS), db_cfg["items"])
        db = ReceiverDB(params, DebugOprf(cfg["oprf_key"]), loc_seed=loc_seed, device=device)
        db.set_data(inputs.db_items, assume_unique=True)
        return db, None
    raise SystemExit(f"unknown DB kind {db_cfg['kind']!r}")


def _plant(roots_dev: torch.Tensor, g: torch.Generator, t: int, every: int) -> np.ndarray:
    """Query values [B, N]: lane n holds the root (cache n % C, depth n % K)
    of its lane where n % every == 0, else a value in [1, t) that no bin of
    that lane holds (drawn again until it is none)."""
    B, C, K, N = roots_dev.shape
    lanes = torch.arange(N, device=roots_dev.device)
    x = torch.randint(1, t, (B, N), generator=g, dtype=torch.int32, device=roots_dev.device)
    for b in range(B):
        while True:
            hit = (roots_dev[b] == x[b]).any(dim=1).any(dim=0)
            if not bool(hit.any()):
                break
            fresh = torch.randint(1, t, (N,), generator=g, dtype=torch.int32,
                                  device=roots_dev.device)
            x[b] = torch.where(hit, fresh, x[b])
    planted = roots_dev[:, lanes % C, lanes % K, lanes]
    x = torch.where(lanes % every == 0, planted, x)
    return x.cpu().numpy().view(np.uint32)


def _on_host(req):
    """The request as it arrives off the wire: its tensors in host memory."""
    req.powers_data = req.powers_data.cpu()
    if req.relin_key is not None:
        req.relin_key = req.relin_key.cpu()
    return req


def _dense_pool(traffic, params, seed, device, roots_dev, inputs) -> list:
    from apsu_tpu_torch.api.parties import QueryRequest
    from apsu_tpu_torch.core.bfv import BfvContext, SecretKey
    from apsu_tpu_torch.db.measured_levels import query_level

    t, n = params.seal_params.plain_modulus, params.poly_degree
    bfv = BfvContext(params.seal_params, device=device)
    ql = query_level(params, len(bfv.q_primes))
    plist = tuple(params.query_params.query_powers)
    g = device_generator(seed, PLANT, device)
    reqs = []
    for i in range(traffic["pool"]):
        rng = stream(seed, SENDER, i)
        sk = rng.integers(-1, 2, size=n).astype(np.int8)
        x = _plant(roots_dev, g, t, traffic["match_every"])
        stack = np.stack([_pow_mod(x, s, t) for s in plist]).astype(np.uint32)
        key = SecretKey(sk)
        a_seed, rk_seed = bytes(rng.bytes(32)), bytes(rng.bytes(32))
        ct = bfv.encrypt_symmetric(bfv.encode(stack), key, rng, a_seed=a_seed, level=ql)
        rk = bfv.gen_relin_key(key, rng, a_seed=rk_seed, level=ql)
        reqs.append(_on_host(QueryRequest(power_list=plist, powers_data=ct.data,
                                          relin_key=rk.ksk, a_seed=a_seed, rk_seed=rk_seed)))
        inputs.secrets.append(sk)
        inputs.query_values.append(x)
    return reqs


def _item_pool(cfg, traffic, params, seed, device, inputs) -> list:
    from apsu_tpu_torch.api.parties import Sender
    from apsu_tpu_torch.core.bfv import SecretKey
    from apsu_tpu_torch.mpc.oprf import DebugOprf

    m = cfg["sender"]["items"]
    common = int(round(m * traffic["common_share"]))
    reqs = []
    for i in range(traffic["pool"]):
        rng = stream(seed, SENDER, i)
        pick = rng.choice(len(inputs.db_items), size=common, replace=False)
        items = np.concatenate([inputs.db_items[pick], _distinct_items(rng, m - common)])
        items = items[rng.permutation(m)]
        snd = Sender(params, DebugOprf(cfg["oprf_key"]), rng=rng,
                     loc_seed=cfg["loc_seed"].encode(), device=device)
        # the harness's own secret, so that the reference can decrypt
        sk = rng.integers(-1, 2, size=params.poly_degree).astype(np.int8)
        snd.sk = SecretKey(sk)
        if snd.rk is not None:
            snd.rk = snd.bfv.gen_relin_key(snd.sk, rng, a_seed=snd.rk_seed, level=snd.query_lvl)
        reqs.append(_on_host(snd.create_query(items)))
        inputs.secrets.append(sk)
        inputs.query_items.append(items)
    return reqs


def make(cfg: dict, traffic: dict, seed: int, device, marks: list) -> tuple:
    """(params, DB, pool of requests, Inputs).  The pool holds
    ``traffic['pool']`` requests from distinct senders, each with its own
    secret and relinearization keys, in host memory.  Dense DBs: query values
    planted in the roots every ``match_every`` lanes, encrypted directly; item
    DBs: a ``Sender`` over the configuration's sender items, a
    ``common_share`` of them drawn from the receiver's items.  Appends
    (phase, perf_counter) to ``marks`` as each phase ends."""
    import time

    params = load_params(cfg)
    check_moduli(cfg, params)
    inputs = Inputs(mask_key=receiver_key(seed))
    db, roots_dev = build_db(cfg, params, seed, device, inputs)
    marks.append(("db", time.perf_counter()))
    if roots_dev is not None:
        reqs = _dense_pool(traffic, params, seed, device, roots_dev, inputs)
        del roots_dev
    else:
        reqs = _item_pool(cfg, traffic, params, seed, device, inputs)
    marks.append(("pool", time.perf_counter()))
    return params, db, reqs, inputs
