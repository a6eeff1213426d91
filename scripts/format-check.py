#!/usr/bin/env python3
"""Format gate for cpp/ (reference parity: format-check.py).

Runs clang-format --dry-run --Werror when available. When clang-format is
NOT installed this gate does not silently pass: it
falls back to a built-in mechanical check of the invariants our
.clang-format guarantees (100-column limit, no tabs, no trailing
whitespace, newline at EOF, no CRLF) and exits nonzero on violations —
and exits nonzero outright if --require-clang-format was given.
"""

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COLUMN_LIMIT = 100  # cpp/.clang-format ColumnLimit


def cpp_files() -> list[Path]:
    return [
        p
        for pat in ("cpp/**/*.cpp", "cpp/**/*.hpp")
        for p in ROOT.glob(pat)
        if not any(part.startswith("build") for part in p.parts)
    ]


def builtin_check(files: list[Path]) -> int:
    bad = 0
    for path in files:
        raw = path.read_bytes()
        if b"\r" in raw:
            print(f"{path}: CRLF line ending", file=sys.stderr)
            bad += 1
        if raw and not raw.endswith(b"\n"):
            print(f"{path}: missing newline at EOF", file=sys.stderr)
            bad += 1
        for i, line in enumerate(raw.decode("utf-8").splitlines(), 1):
            if "\t" in line:
                print(f"{path}:{i}: tab character", file=sys.stderr)
                bad += 1
            if line != line.rstrip():
                print(f"{path}:{i}: trailing whitespace", file=sys.stderr)
                bad += 1
            if len(line) > COLUMN_LIMIT:
                print(
                    f"{path}:{i}: line exceeds {COLUMN_LIMIT} columns "
                    f"({len(line)})",
                    file=sys.stderr,
                )
                bad += 1
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--require-clang-format",
        action="store_true",
        help="fail (exit 2) when clang-format is not installed, instead of "
        "running the built-in fallback checks",
    )
    args = ap.parse_args()
    files = cpp_files()
    if not files:
        print("no C++ sources found", file=sys.stderr)
        return 2

    if shutil.which("clang-format"):
        proc = subprocess.run(
            ["clang-format", "--dry-run", "--Werror", *map(str, files)],
            capture_output=True,
            text=True,
        )
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            print(
                "format check FAILED; run: clang-format -i "
                + " ".join(map(str, files))
            )
            return 1
        print(f"format check ok ({len(files)} files, clang-format)")
        return 0

    if args.require_clang_format:
        print("clang-format not installed (required)", file=sys.stderr)
        return 2
    bad = builtin_check(files)
    if bad:
        print(f"format check FAILED ({bad} violations, builtin fallback)")
        return 1
    print(
        f"format check ok ({len(files)} files, builtin fallback — "
        "clang-format not installed)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
