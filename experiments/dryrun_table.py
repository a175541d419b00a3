"""PERF.md's dry-run table from the JSON files ``launch/dryrun.py`` wrote.

    PYTHONPATH=src python experiments/dryrun_table.py [DIR]
    PYTHONPATH=src python experiments/dryrun_table.py --before BEFORE_DIR [DIR]

One row a (arch, shape) cell, the single-pod (16, 16) and multi-pod
(2, 16, 16) meshes side by side as "pod1 / pod2": status, argument and
peak GiB of the traced rank, whether the peak fits the card's 80 GiB,
TFLOP of the rank, collective GB by kind (ag all-gather, ar all-reduce,
a2a all-to-all, rd reduce, bc broadcast, p2p send) and the dominant
roofline term. Cells with a tag (variants) get rows of their own. Every
number is an analytic bound or a count of the meta trace, not a time.
Cells skipped on both meshes are listed after the table. With
``--before`` it prints, for every train and prefill cell, the peak GiB
and TFLOP of the traced rank in BEFORE_DIR (another commit's sweep) and
in DIR side by side, "pod1 / pod2" each, the counts of cells that fit
80 GiB in each, and each cell whose status differs. With
``--before-decode`` the same for the decode cells (decode_32k, long_500k):
peak and argument GiB and collective GB of the traced rank, before and
after.
"""

import json
import pathlib
import sys

DIR = pathlib.Path(__file__).resolve().parent / "dryrun_torch"
KINDS = (("all-gather", "ag"), ("all-reduce", "ar"), ("all-to-all", "a2a"), ("reduce", "rd"),
         ("broadcast", "bc"), ("send", "p2p"))


def _gb(nbytes: float) -> str:
    x = nbytes / 1e9
    return f"{x:.0f}" if x >= 100 else f"{x:.3g}" if x >= 0.01 else "<0.01"


def cell(r) -> dict:
    if r is None:
        return {k: "—" for k in ("status", "arg", "peak", "fits", "tflop", "coll", "dom")}
    if r["status"] != "ok":
        return {"status": r["status"], "arg": "—", "peak": "—", "fits": "—", "tflop": "—",
                "coll": "—", "dom": "—"}
    m, c = r["memory"], r["collectives"]
    coll = " ".join(f"{short} {_gb(c[kind])}" for kind, short in KINDS if c.get(kind))
    return {"status": "ok", "arg": f"{m['argument_bytes'] / 2**30:.1f}",
            "peak": f"{m['peak_bytes'] / 2**30:.1f}", "fits": "yes" if m["fits_80gib"] else "no",
            "tflop": f"{r['cost']['flops'] / 1e12:.1f}", "coll": coll or "none",
            "dom": r["roofline"]["dominant"]}


def load(path) -> dict:
    """{(arch, shape, tag): {mesh: result}} of a sweep's JSON files."""
    rows = {}
    for f in sorted(pathlib.Path(path).glob("*.json")):
        r = json.loads(f.read_text())
        parts = f.stem.split("__")
        tag = parts[3] if len(parts) > 3 else ""
        rows.setdefault((r["arch"], r["shape"], tag), {})[r["mesh"]] = r
    return rows


def compare(before_path, path=DIR, decode=False) -> None:
    before, after = load(before_path), load(path)

    def pair(by_mesh, key):
        return " / ".join(cell(by_mesh.get(m))[key] for m in ("pod1", "pod2"))

    keys = ("peak", "arg", "coll") if decode else ("peak", "tflop")
    heads = {"peak": "peak GiB", "arg": "arg GiB", "coll": "collective GB", "tflop": "TFLOP"}
    print("| arch | shape | " + " | ".join(f"{heads[k]} before | {heads[k]} after" for k in keys)
          + " |")
    print("|---|---|" + "---|---|" * len(keys))
    for key in sorted(set(before) | set(after)):
        arch, shape, tag = key
        b, a = before.get(key, {}), after.get(key, {})
        if not any(r["status"] == "ok" for r in list(b.values()) + list(a.values())):
            continue
        if (shape.startswith("decode") or shape.startswith("long")) != decode:
            continue
        name = f"{shape} ({tag})" if tag else shape
        print(f"| {arch} | {name} | "
              + " | ".join(f"{pair(b, k)} | {pair(a, k)}" for k in keys) + " |")
    for label, rows in (("before", before), ("after", after)):
        cells = [r for by_mesh in rows.values() for r in by_mesh.values() if r["status"] == "ok"]
        fits = sum(r["memory"]["fits_80gib"] for r in cells)
        print(f"{label}: {len(cells)} cells ok, {fits} fit 80 GiB")
    for key in sorted(set(before) & set(after)):
        for m in ("pod1", "pod2"):
            sb = before[key].get(m, {}).get("status")
            sa = after[key].get(m, {}).get("status")
            if sb != sa:
                print(f"status {' '.join(key)} {m}: {sb} -> {sa}")


def main(path=DIR) -> None:
    rows, skipped = load(path), []
    print("| arch | shape | status | arg GiB | peak GiB | fits 80 GiB | TFLOP | collective GB |"
          " dominant |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (arch, shape, tag), by_mesh in rows.items():
        if all(r["status"] == "skipped" for r in by_mesh.values()):
            skipped.append(f"{arch} {shape}")
            continue
        a, b = cell(by_mesh.get("pod1")), cell(by_mesh.get("pod2"))
        both = [f"{a[k]} / {b[k]}" for k in ("status", "arg", "peak", "fits", "tflop")]
        coll = a["coll"] if b["coll"] == "—" else f"{a['coll']} / {b['coll']}"
        name = f"{shape} ({tag})" if tag else shape
        print(f"| {arch} | {name} | " + " | ".join(both) + f" | {coll} | {a['dom']} / {b['dom']} |")
    if skipped:
        print(f"Skipped on both meshes (`cell_supported`): {', '.join(skipped)}.")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--before"]:
        compare(*sys.argv[2:])
    elif sys.argv[1:2] == ["--before-decode"]:
        compare(*sys.argv[2:], decode=True)
    else:
        main(*sys.argv[1:])
