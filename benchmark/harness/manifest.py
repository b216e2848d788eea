"""BENCHMARK.json and the files it names, found by name.

    configs/<config>.json       a configuration: the scene, sizes, dtype
    traffic/<traffic>.json      a traffic mix; its "kind" names
    drivers/<kind>.py           the loop that drives the program
    limits/<workload>.json      the limits of the cell's output check
    metrics/<metric>.py         a metric's reader; <name>.<kind> falls back
                                to metrics/<name>.py

A later cell, mix or metric is new files and new entries, never an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json; available: "
                   f"{[w['name'] for w in man['workloads']]}")


def config(name):
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name):
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(workload_name):
    return load_json(os.path.join(BENCH_DIR, "limits",
                                  f"{workload_name}.json"))


def driver(kind):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name):
    """The module of metrics/<name>.py; a name with a suffix after its
    last dot (`fwd_ms_per_step.trajopt`) falls back to the reader of the
    name without it (metrics/fwd_ms_per_step.py), so that one reader
    serves every cell kind."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics",
                            f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_for(man, workload_name):
    """The end-to-end metrics a cell reports."""
    return [m for m in man["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def per_layer_for(man, workload_name):
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose `moves` the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(man, workload_name)}
    out = []
    for m in man["per_layer"]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
