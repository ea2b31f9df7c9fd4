"""Re-derive the cost fields of every dry-run record from its saved op
trace (``<tag>.ops.json``, ``dryrun --save-ops``) under the current rules
of ``launch/hlocost.py`` and the kernels' ``cost(...)``, without running
the step again (port of ``repro/launch/reanalyze.py``, which re-reads the
saved ``.hlo``).

  PYTHONPATH=src python -m repro_torch.launch.reanalyze
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.hlocost import recount
from repro_torch.launch.roofline import ART_DIR


def main(art_dir: str | None = None) -> int:
    n = 0
    for jpath in sorted(glob.glob(os.path.join(art_dir or ART_DIR,
                                               "*.json"))):
        if jpath.endswith(".ops.json"):
            continue
        opath = jpath[:-5] + ".ops.json"
        if not os.path.exists(opath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        with open(opath) as f:
            t = recount(json.load(f))
        rec["flops"] = t["flops"]
        rec["hlo_bytes"] = t["bytes"]
        rec["coll_bytes"] = t["coll_bytes"]
        rec["coll_by_kind"] = t["coll_by_kind"]
        if "coll_by_axis" in rec:       # a train cell's
            rec["coll_by_axis"] = t["coll_by_axis"]
        rec["kernel_credits"] = t["kernel_credits"]
        rec["unknown_trip_whiles"] = 0
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"re-analyzed {n} records")
    return n


if __name__ == "__main__":
    main()
