"""One timing script run on several checkouts in turns: the driver of ``attn_turns`` and ``affine_turns``.

A tool supplies the body of a child script and what it times (``payload``).
For each tree, a checkout of this repository, a child process whose working
directory and first import path is the tree runs the body: the tree's
wrappers build and launch the tree's kernels, while ``profiling`` (CUDA
events, whole traces) comes from this checkout, so every tree is measured
alike.  Each round runs the trees in turns, the order reversed every other
round (A B, B A, ...), so a drift of the card's clocks falls on all alike;
the medians over the rounds fold every number the turns report.

``sass`` builds ``csrc/<source>`` of two trees and compares each kernel's
SASS.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROFILING = Path(__file__).resolve().with_name("profiling.py")

# every child body starts here: ``args`` (the payload) and ``profiling``
PRELUDE = r"""
import importlib.util, json, sys
args = json.loads(sys.argv[1])
_spec = importlib.util.spec_from_file_location("_turns_profiling", sys.argv[2])
profiling = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(profiling)
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_child(tree: Path, body: str, payload: dict) -> dict:
    """``body`` (after ``PRELUDE``) in a child process on ``tree``; the JSON
    object it prints last."""
    proc = subprocess.run([sys.executable, "-c", PRELUDE + body, json.dumps(payload),
                           str(PROFILING)], cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def median(results: list):
    """The median of each number across ``results`` of one structure
    (nested dicts of numbers; lists, per-shape detail, are left out)."""
    first = results[0]
    if isinstance(first, dict):
        return {k: median([r[k] for r in results]) for k, v in first.items()
                if not isinstance(v, list)}
    return statistics.median(results)


def parser(doc: str, iters: int) -> argparse.ArgumentParser:
    """The options every tool takes: ``--trees``, ``--rounds``, ``--iters``,
    ``--sass`` and ``--out``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--trees", nargs="*", type=Path, default=[REPO])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", type=Path)
    return ap


class Record:
    """What a run found: the card, the trees, each turn and the medians;
    printed as it comes and written to ``out`` after every step, so that a
    failure keeps what ran."""

    def __init__(self, trees: list[Path], out: Path | None):
        self.out = out
        self.data = {"card": card(), "trees": [str(t) for t in trees], "turns": []}
        print(self.data["card"], flush=True)

    def add(self, key: str, value) -> None:
        self.data[key] = value
        print(json.dumps({key: value}), flush=True)
        self.save()

    def save(self) -> None:
        if self.out:
            self.out.parent.mkdir(parents=True, exist_ok=True)
            self.out.write_text(json.dumps(self.data, indent=1))


def _brief(value):
    if isinstance(value, dict):
        return {k: _brief(v) for k, v in value.items() if not isinstance(v, list)}
    return value


def in_turns(trees: list[Path], rounds: int, body: str, payload: dict, record: Record) -> None:
    """``rounds`` rounds of ``body`` on every tree in turns, then the
    medians per tree (``record``'s ``turns`` and ``median``)."""
    turns = record.data["turns"]
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            turns.append({"tree": str(tree), "round": r,
                          "results": run_child(tree, body, payload)})
            print(json.dumps(_brief(turns[-1])), flush=True)
            record.save()
    if turns:
        record.add("median", {str(t): median([x["results"] for x in turns if x["tree"] == str(t)])
                              for t in trees})


def sass(trees: list[Path], source: str, keep=lambda name: True) -> dict:
    """The SASS of each kernel of the first tree's build of ``csrc/<source>``
    whose mangled name ``keep`` takes, against the second's."""
    if len(trees) < 2:
        raise SystemExit("--sass compares two trees")
    sys.path.insert(0, str(REPO))
    from xmc_gan_tpu_torch.ops.cuda.build import NVCC_FLAGS, find_nvcc

    nvcc = find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    funcs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees[:2]):
            lib = os.path.join(tmp, f"lib{i}.so")
            subprocess.run([nvcc, *NVCC_FLAGS, "-o", lib,
                            str(tree / "xmc_gan_tpu_torch" / "csrc" / source)],
                           check=True, capture_output=True)
            text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                                  check=True).stdout
            # the anonymous namespace's name carries a per-file hash
            text = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", text)
            parts = {}
            for part in re.split(r"\n\s*Function : ", text)[1:]:
                name, body = part.split("\n", 1)
                if not keep(name.strip()):
                    continue
                parts[name.strip()] = re.sub(r"[ \t]+", " ", body.split("\n\t\t..........")[0])
            funcs.append(parts)
    first, second = funcs
    return {"identical": sorted(n for n in first if second.get(n) == first[n]),
            "differ": sorted(n for n in first if n in second and second[n] != first[n]),
            "missing": sorted(n for n in first if n not in second),
            "new": sorted(n for n in second if n not in first)}
