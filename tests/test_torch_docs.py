"""The port's counterpart of tests/test_docs.py: every ``from
rsvd_kamaneh_raganato_terrana_tpu[...] import ...`` in a python block
of docs/USAGE.md resolves in the port's same-named module
(``linalg.pallas_kernels`` is the port's ``linalg.kernels``), so the
guide reads as well for the PyTorch package as for the JAX one."""

import importlib
import os
import re

DOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "USAGE.md")
JAX_PKG = "rsvd_kamaneh_raganato_terrana_tpu"
PORT_PKG = JAX_PKG + "_torch"
_PAT = re.compile(
    rf"from ({JAX_PKG}(?:\.[\w.]+)?) import \(?([^)]*?)\)?\s*$", re.M)
RENAMED = {".linalg.pallas_kernels": ".linalg.kernels"}


def port_module(name: str) -> str:
    """The port's module of the JAX package's module ``name``."""
    rest = name[len(JAX_PKG):]
    return PORT_PKG + RENAMED.get(rest, rest)


def test_usage_md_imports_resolve_in_the_port():
    src = open(DOC).read()
    blocks = re.findall(r"```python\n(.*?)```", src, re.S)
    assert blocks, "USAGE.md has no python blocks?"
    checked, problems = 0, []
    for b in blocks:
        text = re.sub(r"\(\s*\n", "(", b)
        text = re.sub(r",\s*\n\s*", ", ", text)
        for m in _PAT.finditer(text):
            mod_name, names = port_module(m.group(1)), m.group(2)
            names = [n.strip().rstrip(",") for n in names.split(",")
                     if n.strip() and not n.strip().startswith("#")]
            try:
                module = importlib.import_module(mod_name)
            except Exception as e:  # pragma: no cover - report below
                problems.append(f"{mod_name}: {e}")
                continue
            for n in names:
                checked += 1
                if not hasattr(module, n):
                    problems.append(f"{mod_name}.{n} missing")
    assert not problems, problems
    assert checked >= 60, checked


def test_port_module_names():
    assert port_module(JAX_PKG) == PORT_PKG
    assert port_module(JAX_PKG + ".rsvd.fd") == PORT_PKG + ".rsvd.fd"
    assert (port_module(JAX_PKG + ".linalg.pallas_kernels")
            == PORT_PKG + ".linalg.kernels")
