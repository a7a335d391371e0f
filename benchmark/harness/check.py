"""Whether the responses are right: each checked response is decrypted by
the plain reference and held, slot for slot, against mask + ∏(x − r) that the
reference works out from the seed's inputs and the receiver's mask draws.

The comparison is exact: ``wrong_slots`` has the limit 0.  Its control holds
each response against the mask of the receiver's next query instead, which a
program that did not bind each response to its own fresh mask would pass.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import matching, placement, ring


def _layout(params) -> placement.Layout:
    tp = params.table_params
    return placement.Layout(tp.table_size, params.items_per_bundle, params.felts_per_item,
                            params.item_bit_count_per_felt, params.poly_degree,
                            params.bundle_idx_count)


def matching_tables(cfg: dict, params, inputs, device) -> list:
    """∏(x − r) mod t [B, C, N] for each pool request, on ``device``."""
    t = params.seal_params.plain_modulus
    if cfg["db"]["kind"] == "dense":
        roots, counts = inputs.roots, None
        xs = np.stack(inputs.query_values)                       # [Q, B, N]
    else:
        tp = params.table_params
        layout = _layout(params)
        locs = placement.LocFuncs(tp.table_size, tp.hash_func_count, cfg["loc_seed"].encode())
        roots, counts = placement.receiver_bins(inputs.db_items, locs, layout, cfg["oprf_key"],
                                                tp.max_items_per_bin)
        xs = np.stack([placement.query_values(items, locs, layout, cfg["oprf_key"])
                       for items in inputs.query_items])
    per_bundle = []
    for b in range(roots.shape[0]):
        r = torch.from_numpy(roots[b].view(np.int32)).to(device)
        c = torch.from_numpy(counts[b]).to(device) if counts is not None else None
        x = torch.from_numpy(xs[:, b].view(np.int32)).to(device)
        per_bundle.append(matching.matching_values(x, r, c, t))  # [Q, C, N]
        del r
    return list(torch.stack(per_bundle, dim=1))                  # Q × [B, C, N]


def wrong_slots(cfg: dict, params, inputs, responses, device, control: bool = False) -> dict:
    """Slots of the checked ``responses`` [(ordinal, request index, uint32
    [B, C, 2, L, N])] that differ from the reference; with ``control`` each
    is held against the next query's mask."""
    t = params.seal_params.plain_modulus
    primes = cfg["moduli"]["data"]
    tables = matching_tables(cfg, params, inputs, device)
    wrong = slots = 0
    for ordinal, i, res in responses:
        if res.shape[:2] != tuple(tables[i].shape[:2]):
            raise SystemExit(f"response shape {res.shape} against bins {tuple(tables[i].shape)}")
        ct = torch.from_numpy(res.astype(np.int64)).to(device)
        got = ring.decode(ring.decrypt(ct, inputs.secrets[i], primes, t), t)
        if res.shape[-2] != cfg["levels"]["result"]:   # answered at another level
            wrong += got.numel()
            slots += got.numel()
            continue
        mask = matching.mask_draws(inputs.mask_key, ordinal + int(control), tuple(got.shape), t)
        want = (torch.from_numpy(mask.astype(np.int64)).to(device) + tables[i]) % t
        wrong += int((got != want).sum())
        slots += got.numel()
    return {"wrong_slots": wrong, "slots_checked": slots, "responses_checked": len(responses)}
