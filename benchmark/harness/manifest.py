"""``BENCHMARK.json`` and the files each cell resolves to by name."""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    """The workload entry ``name``, with its configuration, its traffic
    and its limits loaded, and the metrics it reports."""
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    w = dict(found[0])
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(os.path.join(os.path.dirname(BENCH_DIR), conf["file"])) as f:
        w["cfg"] = json.load(f)
    w["mix"] = _json("traffic", w["traffic"] + ".json")
    w["limits"] = _json("limits", name + ".json")
    w["end_to_end"] = [m for m in manifest["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in manifest["per_layer"]
                      if name in m.get("workloads", [name])]
    return w


def metric_reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(record) -> float | None``."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(metric: str) -> List[str]:
    """The union of ``kernels/<metric>/*.txt``: one substring of a device
    kernel's name a line (``#`` starts a comment)."""
    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels", metric,
                                              "*.txt"))):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(line)
    return out


def cell_files(manifest: dict, name: str) -> Dict[str, Optional[str]]:
    """Every file a cell resolves to by name (None where one is missing)."""
    w = next(x for x in manifest["workloads"] if x["name"] == name)
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])

    def there(path):
        return path if os.path.isfile(path) else None

    files = {"config": there(os.path.join(ROOT, conf["file"])),
             "traffic": there(os.path.join(BENCH_DIR, "traffic",
                                           w["traffic"] + ".json")),
             "limits": there(os.path.join(BENCH_DIR, "limits",
                                          name + ".json"))}
    for m in manifest["per_layer"]:
        if name in m.get("workloads", [name]):
            files["metric:" + m["name"]] = there(os.path.join(
                BENCH_DIR, "metrics", m["name"] + ".py"))
    return files
