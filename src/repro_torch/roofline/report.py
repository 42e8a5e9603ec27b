"""Render the dry-run JSON records as markdown tables (the port of
``repro.roofline.report``).

Usage: ``python -m repro_torch.roofline.report [DIR]`` (default
``reports/dryrun_torch``, where ``repro_torch.launch.dryrun`` writes).
"""
from __future__ import annotations

import glob
import json
import os
import sys

DEFAULT_DIR = "reports/dryrun_torch"


def load_records(out_dir: str = DEFAULT_DIR) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_t(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    head = ("| arch | shape | t_compute | t_memory | t_collective | bottleneck "
            "| MODEL_FLOPS/counted | roofline frac |\n"
            "|---|---|---|---|---|---|---|---|")
    rows = [head]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"ERROR | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(r['t_compute'])} "
            f"| {_fmt_t(r['t_memory'])} | {_fmt_t(r['t_collective'])} "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    head = ("| arch | shape | mesh | status | bytes/dev (args+temp, est.) | "
            "counted GFLOPs/dev | coll GB/dev |\n|---|---|---|---|---|---|---|")
    rows = [head]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skipped ({r['reason'][:40]}…) | — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR: {r.get('error','')[:60]} | — | — | — |")
            continue
        ms = r.get("memory_stats", {})
        byt = (ms.get("argument_size_in_bytes", 0)
               + ms.get("temp_size_in_bytes", 0))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {byt/1e9:.2f} GB | {r['flops_per_device']/1e9:.1f} "
            f"| {r['coll_bytes_per_device']/1e9:.2f} |"
        )
    return "\n".join(rows)


def main() -> None:
    recs = load_records(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR)
    print("## Single-pod (16x16) roofline\n")
    print(roofline_table(recs, "16x16"))
    print("\n## Multi-pod (2x16x16) roofline\n")
    print(roofline_table(recs, "2x16x16"))
    print("\n## Dry-run memory/cost records\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
