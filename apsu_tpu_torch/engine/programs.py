"""The query's stages as programs: the port's counterpart of the reference's
program cache (``apsu_tpu/core/bfv.py:_jitted``).

The reference never dispatches a query op by op: it compiles each stage into
one XLA program, cached on its ``BfvContext`` under a static key
(``engine/evaluator.py``: the power tensors, the evaluation, the PS row
chunks).  Here a stage is a *program*: a key, a body, and the tensors the
body reads by address (the DB's).  ``Receiver.run_query`` runs two a query,
split where the reference splits them: the powers (``power_tensor`` or
``ps_power_tensors``) and the evaluation (``matching``, ``matching_labeled``
or ``ps_matching``, with every PS row chunk in one program).

* On a CUDA device the first call for a key copies the inputs into buffers
  that the program owns, runs the body once eagerly on a side stream (which
  fills every lazy cache: NTT tables, BEHZ contexts, the dot product's plan,
  the kernel build), captures the body into a ``torch.cuda.CUDAGraph``,
  reads the hand-written kernels the graph holds (``ops/counts.capture``,
  which raises if they differ from the eager call's launches) and replays
  it.  A later call copies its inputs into the buffers, replays, and adds
  the graph's kernels to the wrappers' counts.
* On the CPU the body runs directly on the same buffers.
* Every call returns outputs that the caller owns (clones of the graph's).
* A failed capture or replay raises; nothing falls back to eager dispatch.
  ``eager()``, the counterpart of ``jax.disable_jit()``, runs the stages op
  by op for the caller that asks (the recording queries of ``chip_smoke.py``
  and the tests).

A key holds the fields of the reference's key tuples that vary in the port
(not the knobs the port fixed: ``APSU_MUL_CHUNK``, ``APSU_PS_INNER``, the
merged wavefront, the batch-first layout, the shard, which the mesh path
keys), the values the body closes over, and what a graph bakes in
(``full_key``): the inputs' shapes and dtypes, the device, and each tensor
read by address (data pointer, shape, strides).  The cache lives on the
context (``BfvContext.programs``); a ``ReceiverDB`` method that frees or
replaces a device tensor calls ``drop`` first, since a graph holds the
address.
"""

from __future__ import annotations

import contextlib

import torch

from apsu_tpu_torch.core.bfv import Ciphertext, RelinKey
from apsu_tpu_torch.device import canonical
from apsu_tpu_torch.engine.evaluator import (
    _row_chunk,
    compute_power_tensor,
    compute_ps_power_tensors,
    eval_matching_polys,
    eval_matching_polys_labeled,
    eval_matching_polys_ps,
    ps_dims,
)
from apsu_tpu_torch.ops import counts

_eager = 0   # depth of eager() blocks; process-wide, as jax.disable_jit()


@contextlib.contextmanager
def eager():
    """While active, every stage runs op by op with no program."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


def key(kind: str, **fields) -> tuple:
    """A program's key: its kind and its named static fields."""
    return (kind, tuple(sorted(fields.items())))


def tensor_id(t: torch.Tensor) -> tuple:
    """What a graph bakes in of a tensor it reads by address."""
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()))


def schedule_key(schedule) -> tuple:
    """A power schedule's identity (the reference's ``_schedule_key``)."""
    return (schedule.sources, schedule.max_power, tuple(tuple(lvl) for lvl in schedule.levels))


class Program:
    """One stage: ``body(bfv, *buffers, *static)`` on buffers that hold a
    copy of each call's inputs, captured into a CUDA graph on the card."""

    def __init__(self, body, inputs, static, device):
        self.body = body
        self.static = tuple(static)
        self.buffers = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs)
        self.graph = None
        self.outs = None
        self.per_call = None   # the launches the graph holds, as counts.COUNTERS

    def __call__(self, bfv, inputs) -> tuple:
        for buf, x in zip(self.buffers, inputs):
            buf.copy_(x)
        if bfv.device.type != "cuda":
            return _as_tuple(self.body(bfv, *self.buffers, *self.static))
        with torch.cuda.device(bfv.device):
            if self.graph is None:
                self.graph, outs, self.per_call = counts.capture(
                    lambda: self.body(bfv, *self.buffers, *self.static))
                self.outs = _as_tuple(outs)
            self.replay()
        return self.outs

    def replay(self) -> None:
        self.graph.replay()
        counts.add(self.per_call)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def full_key(bfv, kind_key: tuple, inputs, static=()) -> tuple:
    """The key of a program in ``bfv.programs``: ``kind_key`` (``key``),
    the device, the shapes and dtypes of ``inputs`` and the identity of each
    ``static`` tensor."""
    return (kind_key, str(canonical(bfv.device)),
            tuple((tuple(x.shape), x.dtype) for x in inputs),
            tuple(tensor_id(t) for t in static))


def run(bfv, kind_key: tuple, body, inputs, static=(), own: bool = True) -> tuple:
    """``body(bfv, *inputs, *static)`` as the program ``kind_key`` of
    ``bfv``: built on the first call for its ``full_key``, replayed after.
    ``inputs`` are copied in each call and may lie on the host; ``static``
    tensors are read by address.  The outputs are the caller's own, or with
    ``own`` False the program's, valid until its next call.  Under
    ``eager()`` the body runs directly."""
    if _eager:
        return _as_tuple(body(bfv, *(x.to(bfv.device) for x in inputs), *static))
    full = full_key(bfv, kind_key, inputs, static)
    prog = bfv.programs.get(full)
    if prog is None:
        prog = Program(body, inputs, static, bfv.device)
        outs = prog(bfv, inputs)   # a failed capture raises here: nothing is kept
        bfv.programs[full] = prog
    else:
        outs = prog(bfv, inputs)
    return tuple(o.clone() for o in outs) if own else outs


def drop(bfv) -> None:
    """Drop ``bfv``'s programs, their buffers and graphs, and give their
    memory back to the card: called before a DB tensor they read is freed
    or replaced."""
    if not bfv.programs:
        return
    cuda = bfv.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(bfv.device)   # no replay still reads them
    bfv.programs.clear()
    if cuda:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the stages of Receiver.run_query; each body closes over static values only
# (no context, so a program does not keep its own context alive)
# ---------------------------------------------------------------------------

def _sources(power_list, datas, level) -> dict:
    return {s: Ciphertext(d, is_ntt=False, level=level) for s, d in zip(power_list, datas)}


def _relin_key(ksk, level):
    return RelinKey(ksk[0], level) if ksk else None


def power_tensor(bfv, datas, power_list, src_lvl, schedule, ksk, eval_level, at_eval):
    """``compute_power_tensor`` as a program, batch-first ([B, D, 2, Le, N]);
    ``datas`` the source ciphertexts in ``power_list``'s order, ``ksk`` the
    relinearization key at ``src_lvl`` or None.  The output is the
    program's (the evaluation copies it in)."""
    rk_lvl = src_lvl if ksk is not None else None
    srcs = tuple(power_list)   # the order the body zips with the inputs
    k = key("power_tensor", schedule=schedule_key(schedule), eval_level=eval_level,
            srcs=srcs, src_lvl=src_lvl, rk_lvl=rk_lvl, at_eval=at_eval)

    def body(bfv, *args):
        cts = _sources(srcs, args[:len(srcs)], src_lvl)
        return compute_power_tensor(bfv, cts, schedule, _relin_key(args[len(srcs):], rk_lvl),
                                    eval_level, at_eval=at_eval).movedim(0, 1).contiguous()

    ins = list(datas) + ([ksk] if ksk is not None else [])
    return run(bfv, k, body, ins, own=False)[0]


def ps_power_tensors(bfv, datas, power_list, src_lvl, plan, ksk, eval_level, at_eval,
                     defer_relin):
    """``compute_ps_power_tensors`` as a program: (low_ntt, high_coeff),
    the program's outputs."""
    rk_lvl = src_lvl if ksk is not None else None
    srcs = tuple(power_list)   # the order the body zips with the inputs
    ph = plan.ps_low_degree + 1
    lvl = eval_level or bfv.q.k
    k = key("ps_power_tensors", low=schedule_key(plan.low), high=schedule_key(plan.high),
            lvl=lvl, low_srcs=tuple(s for s in srcs if s <= plan.ps_low_degree),
            high_srcs=tuple(s // ph for s in srcs if s > plan.ps_low_degree),
            src_lvl=src_lvl, rk_lvl=rk_lvl, at_eval=at_eval, defer_relin=defer_relin)

    def body(bfv, *args):
        cts = _sources(srcs, args[:len(srcs)], src_lvl)
        return compute_ps_power_tensors(bfv, cts, plan, _relin_key(args[len(srcs):], rk_lvl),
                                        eval_level=lvl, at_eval=at_eval,
                                        defer_relin=defer_relin)

    ins = list(datas) + ([ksk] if ksk is not None else [])
    return run(bfv, k, body, ins, own=False)


def matching(bfv, powers, cache, const_slots, mask, eval_level) -> torch.Tensor:
    """``eval_matching_polys`` as a program: the result data [B, C, 2, Le, N]."""
    k = key("eval_matching", eval_level=eval_level)

    def body(bfv, powers, mask, cache, const_slots):
        return eval_matching_polys(bfv, powers, cache, const_slots, mask, eval_level).data

    return run(bfv, k, body, [powers, mask], [cache, const_slots])[0]


def matching_labeled(bfv, powers, cache, const_slots, mask, label_cache, label0_slots, rho,
                     eval_level) -> tuple:
    """``eval_matching_polys_labeled`` as a program: (match data, label data)."""
    k = key("eval_matching_labeled", eval_level=eval_level)

    def body(bfv, powers, mask, rho, cache, const_slots, label_cache, label0_slots):
        res_m, res_l = eval_matching_polys_labeled(bfv, powers, cache, const_slots, mask,
                                                   label_cache, label0_slots, rho, eval_level)
        return res_m.data, res_l.data

    return run(bfv, k, body, [powers, mask, rho],
               [cache, const_slots, label_cache, label0_slots])


def ps_matching(bfv, low, high, cache, const_polys, mask, ksk, rk_lvl, ps_low_degree,
                result_level, max_degree, eval_level) -> torch.Tensor:
    """``eval_matching_polys_ps`` as one program over all its row chunks:
    the result data [B, C, 2, Lr, N]."""
    lvl = eval_level or bfv.q.k
    B, C, planes, N = *cache.shape[:3], cache.shape[-1]
    nh, _ = ps_dims(low, planes, ps_low_degree, max_degree)
    row_chunk, aligned = _row_chunk(bfv, lvl, nh, ps_low_degree, B, C, planes, N)
    k = key("ps_rows", row_chunk=row_chunk, ps_low_degree=ps_low_degree, nh=nh, lvl=lvl,
            result_level=result_level, rk_lvl=rk_lvl, aligned=aligned,
            max_degree=max_degree)

    def body(bfv, low, high, mask, ksk, cache, const_polys):
        return eval_matching_polys_ps(bfv, low, high, cache, const_polys, mask,
                                      RelinKey(ksk, rk_lvl), ps_low_degree, result_level,
                                      max_degree, eval_level=lvl).data

    return run(bfv, k, body, [low, high, mask, ksk], [cache, const_polys])[0]
