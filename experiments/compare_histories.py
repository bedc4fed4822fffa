#!/usr/bin/env python3
"""Compare the histories of two ``chip_smoke.py`` outputs, bit for bit.

    python3 experiments/compare_histories.py PARENT.txt CHANGE.txt

Each file is the standard output of one ``chip_smoke.py`` run (one JSON
object per line; other lines are skipped).  Every list of numbers whose
key names a history (``residuals``, ``norms``, ``errors``, ... : a key
containing "residual", "norm", "err" or "hist") is collected with its
path (phase / key / ...).  The lists present in both runs are compared
value for value (JSON carries the floats exactly); the script prints one
JSON object: how many were compared, how many are equal, the paths of
those that differ, and the paths found in one run only.  It exits 1 if a
list present in both differs.
"""
import json
import sys

HISTORY_WORDS = ("residual", "norm", "err", "hist")


def histories(path):
    out = {}

    def walk(obj, where):
        if isinstance(obj, dict):
            for k, v in obj.items():
                name = f"{where}/{k}" if where else str(k)
                if (isinstance(v, list) and v
                        and all(isinstance(x, (int, float)) for x in v)
                        and any(w in str(k) for w in HISTORY_WORDS)):
                    out[name] = v
                else:
                    walk(v, name)
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                walk(v, f"{where}[{i}]")

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                walk(json.loads(line), "")
            except json.JSONDecodeError:
                continue
    return out


def main(argv):
    a, b = histories(argv[0]), histories(argv[1])
    both = sorted(set(a) & set(b))
    differ = [k for k in both if a[k] != b[k]]
    print(json.dumps({"compared": len(both), "equal": len(both) - len(differ),
                      "differ": differ,
                      "only_in_first": sorted(set(a) - set(b)),
                      "only_in_second": sorted(set(b) - set(a))}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
