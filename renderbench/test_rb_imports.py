"""What the benchmark imports, read from the sources: no module reached
from renderbench/ (through its own modules and the port's, lazy imports
inside functions included) has the top-level name jax, jaxlib, flax or
lsr_tpu, compared whole; and the yardstick (the reference, the bounds, the
comparison, the scene and the arithmetic) reaches nothing of lsr_tpu_torch.
"""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = {"jax", "jaxlib", "flax", "lsr_tpu"}
LOCAL = ("renderbench", "lsr_tpu_torch")


def module_file(name: str):
    """The source file of a module of the checkout, or None."""
    base = os.path.join(ROOT, *name.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def imported(path: str) -> set:
    """Every module name an import statement of the file names (for `from
    a import b`, both a and a.b, since b may be a module)."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import")
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def closure(files) -> set:
    """Module names reached from the files through the checkout's own
    modules."""
    seen, names, todo = set(), set(), list(files)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            names.add(name)
            if name.split(".")[0] in LOCAL:
                parts = name.split(".")
                for i in range(1, len(parts) + 1):
                    f = module_file(".".join(parts[:i]))
                    if f:
                        todo.append(f)
    return names


def sources(sub=""):
    top = os.path.join(HERE, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs
            if f.endswith(".py")]


def test_nothing_reached_is_jax_or_lsr_tpu():
    tops = {n.split(".")[0] for n in closure(sources())}
    assert "lsr_tpu_torch" in tops          # the port is reached...
    assert not tops & BANNED                # ...and nothing of JAX's


@pytest.mark.parametrize("part", ["reference", "kernels/bounds.py",
                                  "correct.py", "ref_side.py", "scene.py",
                                  "stats.py", "profiling.py", "metrics"])
def test_yardstick_reaches_nothing_of_the_port(part):
    files = ([os.path.join(HERE, part)] if part.endswith(".py")
             else sources(part))
    tops = {n.split(".")[0] for n in closure(files)}
    assert "lsr_tpu_torch" not in tops and not tops & BANNED


def test_whole_name_compare():
    # The port's name begins with the JAX package's; whole names differ.
    assert "lsr_tpu_torch".split(".")[0] not in BANNED
    assert "lsr_tpu.frame".split(".")[0] in BANNED
