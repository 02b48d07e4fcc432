"""Generate the API reference (docs/api/) from live docstrings.

The reference builds its Python docs site with pdoc3 (`pythondoc.py` in
/root/reference); this is the equivalent for an environment without pdoc:
a stdlib inspect walk over the public package surface that emits one
markdown file per module.  CI regenerates and diffs the output, so the
committed docs cannot drift from the code.

Run: python pythondoc.py  [--check]
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "docs", "api")

MODULES = [
    "constriction_tpu",
    "constriction_tpu.stream.model",
    "constriction_tpu.stream.stack",
    "constriction_tpu.stream.queue",
    "constriction_tpu.stream.chain",
    "constriction_tpu.symbol",
    "constriction_tpu.symbol.huffman",
    "constriction_tpu.symbol.exp_golomb",
    "constriction_tpu.tpu",
    "constriction_tpu.parallel",
    "constriction_tpu.models.base",
    "constriction_tpu.models.quantized",
    "constriction_tpu.models.categorical",
    "constriction_tpu.models.uniform",
    "constriction_tpu.backends",
    "constriction_tpu.ops.interleaved",
    "constriction_tpu.ops.device_coder",
    "constriction_tpu.ops.route",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if _is_public(n)]
    members = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        home = getattr(obj, "__module__", modname)
        if not (home or modname).startswith("constriction_tpu"):
            continue
        members.append((n, obj))

    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    funcs = [(n, o) for n, o in members if inspect.isfunction(o)]
    consts = [
        (n, o) for n, o in members
        if not inspect.isclass(o) and not inspect.isfunction(o)
        and not inspect.isbuiltin(o)
    ]

    for n, cls in classes:
        lines += [f"## class `{n}{_sig(cls)}`", ""]
        if _doc(cls):
            lines += [_doc(cls), ""]
        for mn, m in inspect.getmembers(cls):
            if not _is_public(mn) and mn != "__init__":
                continue
            if inspect.isfunction(m) and m.__qualname__.startswith(
                cls.__qualname__
            ):
                if mn == "__init__" and (
                    not _doc(m) or _doc(m).startswith("Initialize self.")
                ):
                    continue
                lines += [f"### `{n}.{mn}{_sig(m)}`", ""]
                if _doc(m):
                    lines += [_doc(m), ""]
            elif isinstance(
                inspect.getattr_static(cls, mn, None), property
            ):
                lines += [f"### property `{n}.{mn}`", ""]
                if _doc(m):
                    lines += [_doc(m), ""]
    for n, fn in funcs:
        lines += [f"## `{n}{_sig(fn)}`", ""]
        if _doc(fn):
            lines += [_doc(fn), ""]
    if consts:
        lines += ["## Constants", ""]
        for n, o in consts:
            rep = repr(o)
            if len(rep) > 120:
                rep = rep[:117] + "..."
            lines += [f"- `{n} = {rep}`"]
        lines += [""]
    return "\n".join(lines).rstrip() + "\n"


def main() -> None:
    check = "--check" in sys.argv
    os.makedirs(OUT, exist_ok=True)
    index = [
        "# constriction-tpu API reference",
        "",
        "Generated from docstrings by `pythondoc.py` — do not edit by hand.",
        "",
    ]
    dirty = []
    for modname in MODULES:
        fname = modname.replace(".", "_") + ".md"
        path = os.path.join(OUT, fname)
        text = render_module(modname)
        index.append(f"- [`{modname}`]({fname})")
        if check:
            old = open(path).read() if os.path.exists(path) else ""
            if old != text:
                dirty.append(fname)
        else:
            open(path, "w").write(text)
    index_text = "\n".join(index) + "\n"
    ipath = os.path.join(OUT, "index.md")
    if check:
        old = open(ipath).read() if os.path.exists(ipath) else ""
        if old != index_text:
            dirty.append("index.md")
        if dirty:
            raise SystemExit(
                "API docs out of date (regenerate with `python pythondoc.py`): "
                + ", ".join(dirty)
            )
        print("docs/api up to date")
    else:
        open(ipath, "w").write(index_text)
        print(f"wrote {len(MODULES) + 1} files to docs/api/")


if __name__ == "__main__":
    main()
