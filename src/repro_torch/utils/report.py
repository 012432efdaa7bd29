"""Dry-run / perf table generator (the JAX package's ``repro.utils.report``
in PyTorch): the four tables of the port's artifacts
(``artifacts/torch/dryrun``, ``artifacts/torch/perf``), printed, or filled
between the placeholder markers of a document.

    PYTHONPATH=src python -m repro_torch.utils.report [--fill DOC.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
ART = REPO / "artifacts" / "torch"


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table() -> str:
    rows = ["| arch | shape | mesh | params | args GiB/dev | temp GiB/dev | "
            "compile s | status |",
            "|---|---|---|---|---|---|---|---|"]
    for f in sorted((ART / "dryrun").glob("*.json")):
        d = json.loads(f.read_text())
        if d.get("status") == "skipped":
            rows.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — "
                        f"| — | — | skipped (long-context rule) |")
        elif d.get("status") == "ok":
            mem = d.get("memory", {})
            npar = d.get("num_params", 0)
            rows.append(
                f"| {d['arch']} | {d['shape']} | {d['mesh']} "
                f"| {npar/1e9:.2f}B "
                f"| {_fmt_bytes(mem.get('argument_bytes', 0))} "
                f"| {_fmt_bytes(mem.get('temp_bytes', 0))} "
                f"| {d.get('compile_s', 0)} | ok |")
        else:
            rows.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — "
                        f"| — | — | ERROR |")
    return "\n".join(rows)


def roofline_table() -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "bottleneck | useful-FLOPs ratio | roofline frac | next lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    levers = {
        ("train", "memory"): "bf16 flash operands; fewer saved f32 copies",
        ("train", "collective"): "lower µ / FSDP gather amortisation",
        ("prefill", "memory"): "chunked (Sarathi) prefill; bf16 operands",
        ("decode", "collective"): "masked cache write (kill DUS reshard)",
        ("decode", "memory"): "kv-head sharding / cache dtype",
    }
    for f in sorted((ART / "dryrun").glob("*_16x16.json")):
        d = json.loads(f.read_text())
        if d.get("status") != "ok" or "compute_s" not in d:
            continue
        kind = ("decode" if d["shape"] in ("decode_32k", "long_500k")
                else ("prefill" if "prefill" in d["shape"] else "train"))
        lever = levers.get((kind, d["bottleneck"]), "sharding/layout")
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['compute_s']:.4f} "
            f"| {d['memory_s']:.4f} | {d['collective_s']:.4f} "
            f"| **{d['bottleneck']}** | {d['useful_flops_ratio']:.2f} "
            f"| {d['roofline_fraction']:.3f} | {lever} |")
    return "\n".join(rows)


def climber_table() -> str:
    rows = ["| step | mesh | compute s | memory s | collective s | "
            "bottleneck | roofline frac | temp GiB/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for f in sorted((ART / "dryrun").glob("climber_*.json")):
        d = json.loads(f.read_text())
        if d.get("status") != "ok":
            continue
        rows.append(
            f"| {d['shape']} | {d['mesh']} | {d['compute_s']:.4f} "
            f"| {d['memory_s']:.4f} | {d['collective_s']:.4f} "
            f"| **{d['bottleneck']}** | {d['roofline_fraction']:.3f} "
            f"| {_fmt_bytes(d['memory']['temp_bytes'])} |")
    return "\n".join(rows)


def perf_table() -> str:
    groups: dict = {}
    for f in sorted((ART / "perf").glob("*.json")) if (ART / "perf").exists() \
            else []:
        d = json.loads(f.read_text())
        if d.get("status") != "ok":
            continue
        groups.setdefault((d["arch"], d["shape"]), []).append(d)
    out = []
    for (arch, shape), ds in groups.items():
        out.append(f"**{arch} × {shape}**\n")
        out.append("| variant | compute s | memory s | collective s | "
                   "bound s | bottleneck | frac | temp GiB |")
        out.append("|---|---|---|---|---|---|---|---|")
        for d in ds:
            bound = max(d["compute_s"], d["memory_s"], d["collective_s"])
            out.append(
                f"| {d.get('variant','baseline')} | {d['compute_s']:.4f} "
                f"| {d['memory_s']:.4f} | {d['collective_s']:.4f} "
                f"| {bound:.4f} | {d['bottleneck']} "
                f"| {d['roofline_fraction']:.3f} "
                f"| {_fmt_bytes(d['memory']['temp_bytes'])} |")
        out.append("")
    return "\n".join(out)


def fill(marker: str, content: str, text: str) -> str:
    """Idempotent: replaces everything between <!-- X --> and <!-- /X -->."""
    tag, end = f"<!-- {marker} -->", f"<!-- /{marker} -->"
    if tag not in text or end not in text:
        return text
    head = text[: text.index(tag) + len(tag)]
    tail = text[text.index(end):]
    return head + "\n\n" + content + "\n\n" + tail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fill", default=None,
                    help="a document whose DRYRUN_TABLE / ROOFLINE_TABLE / "
                         "CLIMBER_TABLE / PERF_LOG markers get the tables")
    args = ap.parse_args(argv)
    tables = {"DRYRUN_TABLE": dryrun_table(), "ROOFLINE_TABLE": roofline_table(),
              "CLIMBER_TABLE": climber_table(), "PERF_LOG": perf_table()}
    if args.fill is None:
        for marker, table in tables.items():
            print(f"## {marker}\n\n{table}\n")
        return
    doc = Path(args.fill)
    text = doc.read_text()
    # strip previously generated tables back to markers
    for marker, table in tables.items():
        text = fill(marker, table, text)
    doc.write_text(text)
    print(f"{doc} updated")


if __name__ == "__main__":
    main()
