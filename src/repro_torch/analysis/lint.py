"""AST repo-rule linter for the port (twin of ``repro.analysis.lint``).

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default:
``src/repro_torch``).  Emits ``path:line:col CODE message`` per finding
and exits non-zero if any fire.

Rule catalog (the reference's RR001–RR004, on the port's modules):

  RR001  no ``repro_torch.kernels.*`` imports outside
         ``repro_torch/kernels/`` and ``repro_torch/ops/backends/``.
         Kernels are reached through the backend registry
         (``repro_torch.ops``), so dispatch, the plain versions and the
         launch contracts stay in one place.  One more file may import
         them: ``repro_torch/analysis/contracts.py``, because the launch
         contracts are the kernels' own plan functions (imported inside
         its functions, so it still imports without a card).

  RR002  no ``torch.from_numpy(<attribute>)`` /
         ``torch.as_tensor(<attribute>)`` in ``repro_torch/serving/``:
         both may alias the numpy buffer of engine state (``as_tensor``
         does on the CPU), so a later in-place write to e.g. ``self.pos``
         changes the inputs of a step already dispatched — the
         reference's ``jnp.asarray`` hazard in torch form.  Snapshot
         first: ``torch.from_numpy(x.copy())``.

  RR003  no float dtypes (``torch.float16/32/64``, ``bfloat16``,
         ``half``, ``double``) in ``repro_torch/core/`` — the integer
         datapath stays integer; the sanctioned float boundary is
         ``core/quant.py``, as in the reference.  Two functions are
         exempt by (path, function), and nothing else in their modules:

           * ``core/intmath.py::int_einsum`` — CUDA has no integer
             einsum, and a float64 contraction of int8 products is exact:
             every product and every partial sum of up to 2^38 of them is
             an integer below 2^53;
           * ``core/norms.py::quantize_norm_weights`` — the design-time
             float side (gamma / beta to integers in float32 with
             round-half-to-even, as the reference's runs in JAX's
             float32); it runs once at quantization, never on the
             integer path.

  RR004  no ``unpack*(...)`` calls in ``repro_torch/models/`` or
         ``repro_torch/serving/`` — packed weight / KV buffers are
         unpacked only in ``repro_torch/kernels/`` and
         ``repro_torch/ops/`` (the declared plain references and the
         in-kernel paths); dispatch through ``ops.int8_matmul_packed`` /
         the ``kv_shifts``-aware attention ops instead.

``lint_source(src, path)`` and ``lint_paths(paths)`` are the test entry
points.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys

#: rel-path prefixes (within src/) allowed to import repro_torch.kernels.*
KERNEL_IMPORT_ALLOWED = ("repro_torch/kernels", "repro_torch/ops/backends",
                         "repro_torch/analysis/contracts.py")

#: core modules sanctioned to use float dtypes (the dequant boundary)
CORE_FLOAT_ALLOWED = ("repro_torch/core/quant.py",)

#: (path, function) pairs exempt from RR003 (see the module docstring)
CORE_FLOAT_EXEMPT = frozenset({
    ("repro_torch/core/intmath.py", "int_einsum"),
    ("repro_torch/core/norms.py", "quantize_norm_weights"),
})

#: rel-path prefixes (within src/) where RR004 bans unpack*() calls
UNPACK_BANNED = ("repro_torch/models/", "repro_torch/serving/")

FLOAT_DTYPES = frozenset(
    {"float16", "float32", "float64", "bfloat16", "half", "double"})

#: torch calls that may alias a numpy buffer (RR002)
ALIASING_CALLS = frozenset({"from_numpy", "as_tensor"})


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}:{self.col} {self.code} " \
               f"{self.message}"


def _norm(path: str) -> str:
    """Repo-relative posix-ish path for scope matching."""
    p = path.replace(os.sep, "/")
    if "/src/" in p:
        p = p.split("/src/", 1)[1]
    elif p.startswith("src/"):
        p = p[4:]
    return p


def _in_scope(norm: str, prefixes) -> bool:
    return any(norm.startswith(p) for p in prefixes)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, norm: str):
        self.path = path
        self.norm = norm
        self.findings = []
        self.functions = []
        self.check_kernels = (
            norm.startswith("repro_torch/")
            and not _in_scope(norm, KERNEL_IMPORT_ALLOWED))
        self.check_aliasing = norm.startswith("repro_torch/serving/")
        self.check_floats = (norm.startswith("repro_torch/core/")
                             and norm not in CORE_FLOAT_ALLOWED)
        self.check_unpack = _in_scope(norm, UNPACK_BANNED)

    def _emit(self, node, code, message):
        self.findings.append(Finding(self.path, node.lineno,
                                     node.col_offset, code, message))

    def visit_FunctionDef(self, node):
        self.functions.append(node.name)
        self.generic_visit(node)
        self.functions.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # RR001 ------------------------------------------------------------
    def visit_Import(self, node):
        if self.check_kernels:
            for a in node.names:
                if a.name == "repro_torch.kernels" or \
                        a.name.startswith("repro_torch.kernels."):
                    self._emit(node, "RR001",
                               f"direct kernel import '{a.name}' — go "
                               "through the repro_torch.ops backend "
                               "registry")
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if self.check_kernels and (
                mod == "repro_torch.kernels"
                or mod.startswith("repro_torch.kernels.")):
            self._emit(node, "RR001",
                       f"direct kernel import 'from {mod}' — go through "
                       "the repro_torch.ops backend registry")
        self.generic_visit(node)

    # RR002 / RR004 ----------------------------------------------------
    def visit_Call(self, node):
        if self.check_aliasing and self._is_aliasing(node.func) \
                and node.args and isinstance(node.args[0], ast.Attribute):
            arg = ast.unparse(node.args[0])
            self._emit(
                node, "RR002",
                f"{ast.unparse(node.func)}({arg}) may alias mutable "
                "engine state (a numpy buffer) — snapshot first: "
                f"{ast.unparse(node.func)}({arg}.copy())")
        if self.check_unpack:
            name = self._call_name(node.func)
            if name.startswith("unpack"):
                self._emit(
                    node, "RR004",
                    f"'{name}(' call outside kernels/ and ops/ — packed "
                    "buffers are unpacked only below the backend "
                    "boundary; dispatch through the packed ops "
                    "(repro_torch.ops.int8_matmul_packed / kv_shifts)")
        self.generic_visit(node)

    @staticmethod
    def _call_name(func) -> str:
        """The called name: bare ``f(...)`` or the terminal attribute of
        ``mod.f(...)`` — empty for computed callees."""
        if isinstance(func, ast.Name):
            return func.id
        if isinstance(func, ast.Attribute):
            return func.attr
        return ""

    @staticmethod
    def _is_aliasing(func) -> bool:
        return (isinstance(func, ast.Attribute)
                and func.attr in ALIASING_CALLS
                and isinstance(func.value, ast.Name)
                and func.value.id == "torch")

    # RR003 ------------------------------------------------------------
    def visit_Attribute(self, node):
        if self.check_floats and node.attr in FLOAT_DTYPES and not any(
                (self.norm, f) in CORE_FLOAT_EXEMPT for f in self.functions):
            self._emit(node, "RR003",
                       f"float dtype '{ast.unparse(node)}' in an integer "
                       "core module — the integer datapath must stay "
                       "integer (dequant belongs in core/quant.py)")
        self.generic_visit(node)


def lint_source(src: str, path: str = "<memory>"):
    """Lint one source string; returns a list of :class:`Finding`."""
    tree = ast.parse(src, filename=path)
    v = _Visitor(path, _norm(path))
    v.visit(tree)
    return v.findings


def lint_paths(paths):
    """Lint files / directory trees; returns all findings."""
    findings = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(root)
                for f in fs if f.endswith(".py"))
        for f in files:
            with open(f, encoding="utf-8") as fh:
                findings.extend(lint_source(fh.read(), f))
    return findings


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = argv or [os.path.join("src", "repro_torch")]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} repo-rule violation(s)", file=sys.stderr)
        return 1
    print(f"lint ok: {', '.join(paths)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
