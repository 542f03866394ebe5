"""Names of the JAX package with no counterpart in the port.

    python tools/port_coverage.py

Walks every module of `orbslam2_tpu/` and `orbslam2_tpu_torch/` with `ast`
(no import) and prints, one per line, each top-level function, class and
method (`Class.method`) of the reference whose name appears nowhere among
the port's, with its file and line. ROADMAP.md's "Not to port" list names
the ones left out on purpose.
"""

from __future__ import annotations

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def names(package: str) -> dict[str, str]:
    """{qualified name: "file:line"} of a package's top-level functions,
    classes and their methods."""
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        rel = path.relative_to(ROOT)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.setdefault(node.name, f"{rel}:{node.lineno}")
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.setdefault(f"{node.name}.{sub.name}", f"{rel}:{sub.lineno}")
    return out


def main() -> None:
    ref, port = names("orbslam2_tpu"), names("orbslam2_tpu_torch")
    for name, where in sorted(ref.items(), key=lambda kv: kv[1]):
        if name not in port:
            print(f"{where}\t{name}")


if __name__ == "__main__":
    main()
