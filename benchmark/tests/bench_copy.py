"""A copy of the benchmark with a fixture's files and entries added, for
the tests: each fixture under ``fixtures/<name>/`` holds files laid out as
the benchmark's own (``configs/``, ``reference/``, ``counts/``,
``handin/``, ``cells/``, ``traffic/``, ``metrics/``) and ``entries.json``,
the entries it adds to ``BENCHMARK.json``. Nothing of the copy's harness
is edited: the harness under test is the benchmark's own, finding the
fixture by name."""
import json
import shutil
from pathlib import Path

import manifest

FIXTURES = Path(__file__).resolve().with_name("fixtures")
KEYS = ("configs", "workloads", "end_to_end", "per_layer")


def bench_copy(root: Path, *fixtures: str) -> Path:
    """The root of a checkout under ``root`` holding the benchmark and
    ``fixtures``, added as new files and entries."""
    repo = root / "repo"
    shutil.copytree(manifest.BENCH_DIR, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((manifest.REPO / "BENCHMARK.json").read_text())
    for name in fixtures:
        src = FIXTURES / name
        for path in sorted(src.rglob("*")):
            rel = path.relative_to(src)
            if path.is_dir() or path.name == "entries.json" or "__pycache__" in rel.parts:
                continue
            dst = repo / "benchmark" / rel
            if dst.exists():
                # Two fixtures may bring the same file; none may edit one.
                if dst.read_bytes() != path.read_bytes():
                    raise FileExistsError(f"fixture {name} would edit {rel}")
                continue
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, dst)
        entries = json.loads((src / "entries.json").read_text())
        for key in KEYS:
            bench[key] = bench[key] + entries.get(key, [])
    (repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return repo
