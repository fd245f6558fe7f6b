"""Minimal auto-CLI: expose a function's keyword arguments as flags (a copy
of ``himo_tpu/utils/cli.py``).

Replaces the reference's ``fire.Fire`` dispatch (eval.py:316 etc.) without the
dependency. Accepts both ``--key value`` / ``--key=value`` flags and bare
hydra-style ``key=value`` overrides, with values parsed as Python literals
when possible. Every invocation prints ``Time used: {t:.2f} s`` on exit, the
reference's only built-in tracing (SURVEY.md §5).
"""

from __future__ import annotations

import ast
import inspect
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence


def _parse_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_overrides(argv: Sequence[str]) -> Dict[str, Any]:
    """Parse ['--k', 'v', '--k2=v2', 'k3=v3'] into a kwargs dict."""
    kwargs: Dict[str, Any] = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        token = argv[i]
        if token.startswith("--"):
            token = token[2:]
            if "=" in token:
                key, raw = token.split("=", 1)
            else:
                key = token
                if i + 1 < len(argv) and "=" not in argv[i + 1].lstrip("-"):
                    i += 1
                    raw = argv[i]
                else:
                    raw = "True"
            kwargs[key.replace("-", "_")] = _parse_value(raw)
        elif "=" in token:
            key, raw = token.lstrip("+").split("=", 1)
            kwargs[key.replace("-", "_")] = _parse_value(raw)
        else:
            raise SystemExit(f"Cannot parse CLI token: {token!r}")
        i += 1
    return kwargs


def run_cli(fn: Callable, argv: Optional[Sequence[str]] = None) -> Any:
    """Dispatch ``fn`` from CLI args; '-h'/'--help' prints the signature."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-h", "--help") for a in argv):
        sig = inspect.signature(fn)
        doc = inspect.getdoc(fn) or ""
        print(f"usage: {fn.__module__}.{fn.__name__}{sig}\n\n{doc}")
        return None
    kwargs = parse_overrides(argv)
    start = time.time()
    try:
        return fn(**kwargs)
    finally:
        print(f"Time used: {time.time() - start:.2f} s")
