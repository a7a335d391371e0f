"""Power-schedule explorer (port of ``apsu_tpu/cli/pd_tool.py``): given the
query's source powers, the highest power needed and ps_low_degree, print the
wavefront schedule of each power domain and optionally its DOT graph.  Host
only; its output equals the reference tool's, byte for byte.

Usage:
  python -m apsu_tpu_torch.cli.pd_tool --powers 1,3,11,18,45,225 --bound 1304 --ps 44
  python -m apsu_tpu_torch.cli.pd_tool --params parameters/16M-4096.json --dot
"""

from __future__ import annotations

import argparse

from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.engine.powers import PowerSchedule, plan_query


def schedule_dot(schedule: PowerSchedule) -> str:
    """DOT graph of one schedule: sources double-circled, each product an
    edge from both of its operands."""
    lines = ["digraph powers {"]
    for s in schedule.sources:
        lines.append(f'  p{s} [label="{s}" shape=doublecircle];')
    for lvl in schedule.levels:
        for tgt, a, b in lvl:
            lines.append(f'  p{tgt} [label="{tgt}"];')
            lines.append(f"  p{a} -> p{tgt};")
            lines.append(f"  p{b} -> p{tgt};")
    lines.append("}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="apsu_tpu_torch power-schedule tool")
    ap.add_argument("--params", help="parameter JSON (overrides the flags below)")
    ap.add_argument("--powers", help="comma-separated source powers")
    ap.add_argument("--bound", type=int, help="highest power needed")
    ap.add_argument("--ps", type=int, default=0, help="ps_low_degree")
    ap.add_argument("--dot", action="store_true", help="emit DOT graph(s)")
    args = ap.parse_args(argv)

    if args.params:
        p = PSUParams.load_file(args.params)
        powers = p.query_params.query_powers
        bound = p.table_params.max_items_per_bin
        ps = p.query_params.ps_low_degree
    else:
        powers = [int(x) for x in args.powers.split(",")]
        bound = args.bound
        ps = args.ps

    plan = plan_query(powers, bound, ps)
    print(f"sources: {sorted(powers)}  bound: {bound}  ps_low_degree: {ps}")
    print(
        f"low domain: {plan.low.max_power} targets, depth {plan.low.depth}, "
        f"{sum(len(l) for l in plan.low.levels)} ct×ct products"
    )
    if plan.high:
        print(
            f"high domain (y = x^{ps + 1}): {plan.high.max_power} targets, depth "
            f"{plan.high.depth}, {sum(len(l) for l in plan.high.levels)} ct×ct products"
        )
    if args.dot:
        print(schedule_dot(plan.low))
        if plan.high:
            print(schedule_dot(plan.high))


if __name__ == "__main__":
    main()
