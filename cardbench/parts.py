"""Finding the benchmark's parts by name.

A part is a file ``<root>/<kind>/<name><suffix>``: configurations and
traffic mixes are data, generators, clients and metric readers
are Python files imported by path. ``roots`` lists where to look, the
benchmark's own directory first.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
#: the file suffix of each kind of part
SUFFIX = {"configs": ".json", "traffic": ".json", "generators": ".py",
          "clients": ".py", "metrics": ".py"}


def find(kind: str, name: str, roots=(BENCH_DIR,)) -> Path:
    """The file of part ``name`` of ``kind`` under the first root that has
    one."""
    for root in roots:
        path = Path(root) / kind / f"{name}{SUFFIX[kind]}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} part named {name!r} under "
                            f"{[str(r) for r in roots]}")


def names(kind: str, roots=(BENCH_DIR,)) -> list:
    """Every part of ``kind`` under ``roots``, by name."""
    found = set()
    for root in roots:
        for path in (Path(root) / kind).glob(f"*{SUFFIX[kind]}"):
            if not path.name.startswith("_"):
                found.add(path.name[:-len(SUFFIX[kind])])
    return sorted(found)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a part's Python file by its path (a metric's name may hold
    dots, which an import by name would read as packages)."""
    spec = importlib.util.spec_from_file_location(
        f"cardbench_part.{path.parent.name}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
