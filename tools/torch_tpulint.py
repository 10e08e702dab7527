"""tpulint's checks over the PyTorch port: ``python tools/torch_tpulint.py
[--root DIR] [--only FAMILY]``.

tpulint (``tools/tpulint``) reads a tree with the JAX package's layout:
``rabit_tpu/`` (the package), ``native/src`` (the engine's C++),
``doc/parameters.md`` (the documented config keys), ``tools/*.py``,
``tests/**`` and ``guide/**`` (the readers of event kinds and keys).  This
tool builds that layout from the port's files in a temporary directory and
runs every family there, unedited:

* ``rabit_tpu/`` holds ``rabit_tpu_torch/**/*.py`` with the package's name
  rewritten, so the call graph resolves the port's own imports;
* ``native/`` is the repo's (the port builds the same sources);
* ``doc/parameters.md`` is the repo's, followed by the README's port
  section, which documents the ``rabit_torch_*`` keys;
* ``tools/``, ``tests/`` and ``guide/`` hold the port's files there
  (``torch_*``, ``test_torch_*``, ``workers/torch_*``).

Each finding is reported, and fingerprinted, under the port's own path
(``rabit_tpu_torch/...``, and ``README.md`` for a line of the port
section).  The port's baseline is ``tools/torch_tpulint_baseline.json``,
in tpulint's format: every entry argues why it is not a fault.  Exit 0
when nothing falls outside it, 1 on a new finding or (without ``--only``)
a stale entry, 2 on a malformed baseline.  ``--root`` lints the port of
another checkout; ``--only`` runs one family.
"""

from __future__ import annotations

import argparse
import re
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.tpulint import __main__ as tpulint  # noqa: E402
from tools.tpulint.core import BaselineError, Finding, load_baseline  # noqa: E402

PORT = "rabit_tpu_torch"
BASELINE = REPO / "tools" / "torch_tpulint_baseline.json"
#: the README section that documents the port (and its config keys)
README_SECTION = "## The PyTorch/CUDA port"
_PORT_NAME = re.compile(rf"\b{PORT}\b")


def _copy_renamed(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(_PORT_NAME.sub("rabit_tpu", src.read_text(encoding="utf-8")),
                   encoding="utf-8")


def _readme_section(root: Path) -> tuple[list[str], int]:
    """The README's port section and the README line it starts on."""
    lines = (root / "README.md").read_text(encoding="utf-8").splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(README_SECTION))
    end = next((i for i in range(start + 1, len(lines)) if lines[i].startswith("## ")),
               len(lines))
    return lines[start:end], start + 1


def build_mirror(root: Path, out: Path) -> int:
    """Lay the port out under ``out`` as tpulint expects (module
    docstring).  Returns the line of the mirrored doc/parameters.md on
    which the README's section starts."""
    for p in sorted((root / PORT).rglob("*.py")):
        parts = p.relative_to(root / PORT).parts
        if "__pycache__" in parts or "_build" in parts:
            continue
        _copy_renamed(p, out / "rabit_tpu" / Path(*parts))
    shutil.copytree(root / "native" / "src", out / "native" / "src")
    for pattern, dest in (("tools/torch_*.py", "tools"), ("tests/test_torch_*.py", "tests"),
                          ("tests/workers/torch_*.py", "tests/workers"),
                          ("guide/torch_*.py", "guide")):
        for p in sorted(root.glob(pattern)):
            _copy_renamed(p, out / dest / p.name)
    doc = (root / "doc" / "parameters.md").read_text(encoding="utf-8").splitlines()
    section, _ = _readme_section(root)
    (out / "doc").mkdir()
    (out / "doc" / "parameters.md").write_text("\n".join(doc + section) + "\n",
                                               encoding="utf-8")
    return len(doc) + 1


def _to_port(f: Finding, section_line: int, readme_line: int) -> Finding:
    path, line = f.path, f.line
    if path.startswith("rabit_tpu/"):
        path = PORT + path[len("rabit_tpu"):]
    elif path == "doc/parameters.md" and line >= section_line:
        path, line = "README.md", readme_line + line - section_line
    message = f.message.replace("rabit_tpu/", PORT + "/")
    return Finding(f.rule, path, line, message, f.token)


def lint(root: Path = REPO, only: str | None = None) -> list[Finding]:
    """Every family's findings over the port of the tree at ``root``,
    under the port's paths, sorted by file and line."""
    _, readme_line = _readme_section(root)
    with tempfile.TemporaryDirectory(prefix="torch_tpulint-") as tmp:
        mirror = Path(tmp)
        section_line = build_mirror(root, mirror)
        by_family, _seconds = tpulint.run(mirror, only=only)
    found = [_to_port(f, section_line, readme_line) for fs in by_family.values() for f in fs]
    return sorted(found, key=lambda f: (f.path, f.line, f.rule))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_tpulint.py",
                                 description="tpulint's families over rabit_tpu_torch/")
    ap.add_argument("--root", default=str(REPO),
                    help="the repo-layout tree whose port is linted (default: this repo)")
    ap.add_argument("--only", default=None, choices=sorted(tpulint.FAMILIES),
                    metavar="FAMILY", help="run one family: " + ", ".join(tpulint.FAMILIES))
    args = ap.parse_args(argv)
    findings = lint(Path(args.root).resolve(), only=args.only)
    try:
        baseline = load_baseline(BASELINE)
    except BaselineError as exc:
        print(f"torch_tpulint: {exc}", file=sys.stderr)
        return 2
    new = [f for f in findings if f.fingerprint not in baseline]
    stale = [] if args.only else sorted(set(baseline) - {f.fingerprint for f in findings})
    for f in new:
        print(f.render())
    for fp in stale:
        print(f"torch_tpulint: stale baseline entry (suppresses nothing): {fp}")
    print(f"torch_tpulint: {len(new)} new finding(s), {len(findings) - len(new)} baselined, "
          f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'}")
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
