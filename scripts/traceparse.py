"""Parse a jax.profiler trace dump: leaf-op self times + HLO metadata.

Usage: python scripts/traceparse.py [/tmp/hdtrace] [topN]
"""
from __future__ import annotations

import glob
import gzip
import json
import sys


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/hdtrace"
    topn = int(sys.argv[2]) if len(sys.argv) > 2 else 45
    files = glob.glob(f"{outdir}/**/*.trace.json.gz", recursive=True)
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    evs = trace.get("traceEvents", [])
    pid_names = {
        e["pid"]: e["args"].get("name", "")
        for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name" and "args" in e
    }
    agg = {}
    meta = {}
    wrappers = ("while", "conditional", "call", "fused_computation")
    total = 0
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pname = pid_names.get(e["pid"], "")
        if "/device:GPU" not in pname:
            continue
        name = e["name"]
        if any(name.startswith(wname) for wname in wrappers):
            continue
        key = name
        d, c = agg.get(key, (0, 0))
        agg[key] = (d + e["dur"], c + 1)
        total += e["dur"]
        if key not in meta and "args" in e:
            a = e["args"]
            meta[key] = (a.get("long_name") or a.get("tf_op") or a.get("source") or "")[:160]
    print(f"leaf total: {total/1e3:.1f} ms")
    for name, (dur, cnt) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:topn]:
        print(f"{dur/1e3:9.2f} ms x{cnt:4d}  {name[:44]:44s} {meta.get(name,'')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
