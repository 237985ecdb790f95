"""Layer-2 static analysis of the port: AST rules over ``src/repro_torch/**``.

Each rule targets a bug class of a port of JAX kernels to hand-written CUDA
and PyTorch (see the rule table in ``repro_torch.analysis``):

  PHI-LINT-IMPORT          an import of ``jax`` or of the reference package
                           ``repro``: the port runs where neither exists.
  PHI-LINT-FALLBACK        a ``try`` around a kernel wrapper (``*_cuda``) or
                           the library build/load (``_build.library``,
                           ``_build.load``) whose handler carries on instead
                           of raising: a kernel that fails must not quietly
                           become its plain version.
  PHI-LINT-HWCONST         a hardware constant (bandwidths, peaks, shared
                           memory, energies, launch bytes) hard-coded outside
                           ``core/hwconst.py``.
  PHI-LINT-PLACEMENT-DUP   a placement tuple naming one mesh axis twice: a
                           dim split twice over an axis, which the port's
                           shard arithmetic would accept and get wrong.
  PHI-LINT-HOSTSYNC        ``.item()``, ``.tolist()``, ``bool()`` or an
                           ``if``/``while`` on a tensor inside a kernel
                           wrapper or a per-rank body: a host sync per call,
                           and on a dry run's fake tensors an error.

Pure stdlib ``ast``; no module is imported or run. Findings carry a stable
key (rule:path:symbol) so the committed baseline survives line churn.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator

RULE_IMPORT = "PHI-LINT-IMPORT"
RULE_FALLBACK = "PHI-LINT-FALLBACK"
RULE_HWCONST = "PHI-LINT-HWCONST"
RULE_PLACEMENT_DUP = "PHI-LINT-PLACEMENT-DUP"
RULE_HOSTSYNC = "PHI-LINT-HOSTSYNC"
RULES = (RULE_IMPORT, RULE_FALLBACK, RULE_HWCONST, RULE_PLACEMENT_DUP, RULE_HOSTSYNC)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    symbol: str        # enclosing def or assigned name: a stable anchor
    message: str

    @property
    def key(self) -> str:
        """Baseline key: no line number, so edits above a justified finding
        do not stale the baseline."""
        return f"{self.rule}:{self.path}:{self.symbol}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self) | {"key": self.key, "layer": "lint"}


def _attr_chain(node: ast.AST) -> str | None:
    """Dotted name of a Name/Attribute chain ("_build.library", "torch.any")."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _functions(tree: ast.AST):
    return [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _owner(tree: ast.Module) -> dict[int, str]:
    """{id(node): name of the innermost function holding it}."""
    owner: dict[int, str] = {}

    def visit(node, name):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef)) else name
            owner[id(child)] = inner
            visit(child, inner)

    visit(tree, "<module>")
    return owner


# --------------------------------------------------- PHI-LINT-IMPORT ---------
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str | None) -> bool:
    return module is not None and module.split(".")[0] in _FORBIDDEN


def _check_import(tree: ast.Module, path: str) -> Iterator[Finding]:
    owner = _owner(tree)
    for node in ast.walk(tree):
        mods: list[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for mod in mods:
            if _forbidden(mod):
                yield Finding(RULE_IMPORT, path, node.lineno,
                              f"{owner.get(id(node), '<module>')}:{mod}",
                              f"imports `{mod}`: the port imports neither jax nor the "
                              "reference package (its tests hold it against them)")


# ------------------------------------------------- PHI-LINT-FALLBACK ---------
_LOADERS = {"library", "load", "_build"}


def _launches_kernel(node: ast.AST) -> str | None:
    """The first call under ``node`` to a kernel wrapper or the library
    build/load, by name."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = _attr_chain(sub.func) or ""
            tail = chain.rsplit(".", 1)[-1]
            if tail.endswith("_cuda") or (chain.startswith("_build.") and tail in _LOADERS):
                return chain
    return None


def _check_fallback(tree: ast.Module, path: str) -> Iterator[Finding]:
    owner = _owner(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        call = None
        for stmt in node.body:
            call = call or _launches_kernel(stmt)
        if call is None:
            continue
        for h in node.handlers:
            if not any(isinstance(s, ast.Raise) for s in ast.walk(h)):
                yield Finding(RULE_FALLBACK, path, h.lineno,
                              f"{owner.get(id(node), '<module>')}:{call}",
                              f"a handler around `{call}(...)` carries on without raising: "
                              "no path falls back to a plain version when a kernel fails "
                              "to build or launch")
                break


# -------------------------------------------------- PHI-LINT-HWCONST ---------
# Module-level names that look like hardware constants: the vocabulary of
# core/hwconst.py (the paper's ASIC and the H100).
_HWCONST_RE = re.compile(
    r"^_?("
    r"E_\w+_PJ(_B)?|\w+_GBPS|\w+_BPC|\w+_PJ_PER_\w+|FREQ|\w+_POWER_W"
    r"|\w*_?LAUNCH_BYTES|\w*BUDGET_BYTES|PACKER_\w+|PWP_BUFFER_KB"
    r"|MATCHER_WIDTH|DRAM_\w+|\w*PEAK_FLOPS|\w+_BW|HBM_\w+|ICI_\w+|NVLINK_\w+"
    r"|\w*_FLOP_PER_S|\w*_OPS_PER_S|\w*_B_PER_S|SM_SMEM\w*|\w*SMEM_PER_\w+|N_SMS|SMS"
    r")$")
_HWCONST_HOME = "core/hwconst.py"


def _is_numeric_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
    if isinstance(node, ast.BinOp):
        return _is_numeric_literal(node.left) and _is_numeric_literal(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    return False


def _check_hwconst(tree: ast.Module, path: str) -> Iterator[Finding]:
    if path.replace("\\", "/").endswith(_HWCONST_HOME):
        return
    for node in tree.body:                 # module level only
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and _HWCONST_RE.match(t.id) \
                    and _is_numeric_literal(value):
                yield Finding(RULE_HWCONST, path, node.lineno, t.id,
                              f"hardware constant `{t.id}` hard-coded outside "
                              f"{_HWCONST_HOME}: import it from core.hwconst so every "
                              "bound and model reads one source")


# -------------------------------------------- PHI-LINT-PLACEMENT-DUP ---------
MESH_AXES = frozenset({"pod", "data", "model"})


def _placement_axes(node: ast.AST) -> list[str] | None:
    """The mesh axes of a placement literal: a tuple whose entries are each
    None, a mesh axis name or a tuple of them (at least one name); else
    None."""
    if not isinstance(node, ast.Tuple) or not node.elts:
        return None
    axes: list[str] = []
    for e in node.elts:
        if isinstance(e, ast.Constant) and e.value is None:
            continue
        if isinstance(e, ast.Constant) and e.value in MESH_AXES:
            axes.append(e.value)
        elif isinstance(e, ast.Tuple) and e.elts and all(
                isinstance(x, ast.Constant) and x.value in MESH_AXES for x in e.elts):
            axes += [x.value for x in e.elts]
        else:
            return None
    return axes or None


def _check_placement_dup(tree: ast.Module, path: str) -> Iterator[Finding]:
    owner = _owner(tree)
    inner = {id(e) for n in ast.walk(tree) if isinstance(n, ast.Tuple) for e in n.elts}
    for node in ast.walk(tree):
        if id(node) in inner:
            continue                       # judged as part of its outer tuple
        axes = _placement_axes(node)
        if axes is None:
            continue
        dups = sorted({a for a in axes if axes.count(a) > 1})
        if dups:
            yield Finding(RULE_PLACEMENT_DUP, path, node.lineno,
                          f"{owner.get(id(node), '<module>')}:({','.join(axes)})",
                          f"placement names mesh axis {dups} more than once: a dim split "
                          "twice over one axis")


# --------------------------------------------------- PHI-LINT-HOSTSYNC -------
# Where a host sync costs a call's latency and breaks a dry run's fake
# tensors: the kernel wrappers (kernels/*.py functions named *_cuda and the
# launch helpers) and the per-rank bodies of the mesh (the model code that
# runs on a rank's shards, and the collectives).
_RANK_BODY_FILES = ("models/layers.py", "models/transformer.py", "models/model.py",
                    "models/mamba2.py", "models/moe.py", "models/flash.py",
                    "distributed/collectives.py")
# torch calls that return host values, not tensors.
_HOST_TORCH = {"is_grad_enabled", "is_tensor", "is_floating_point", "device", "dtype",
               "finfo", "iinfo", "Size", "get_default_dtype", "is_inference_mode_enabled",
               "cuda.is_available", "version.cuda", "equal_shape"}
_TENSOR_METHODS = {"any", "all", "item", "sum", "max", "min", "amax", "amin", "eq", "ne",
                   "isnan", "isfinite", "count_nonzero", "nonzero"}


def _in_scope(path: str, fn: str) -> bool:
    p = path.replace("\\", "/")
    if "/kernels/" in p and (fn.endswith("_cuda") or fn.startswith("_launch")):
        return True
    return p.endswith(_RANK_BODY_FILES)


def _tensor_call(node: ast.AST) -> str | None:
    """A call under ``node`` that gives a tensor: ``torch.<fn>`` (not a host
    query) or a reducing tensor method."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = _attr_chain(sub.func) or ""
        if chain.startswith("torch.") and chain[len("torch."):] not in _HOST_TORCH:
            return chain
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in _TENSOR_METHODS \
                and not chain.startswith(("np.", "numpy.", "math.")):
            return chain or sub.func.attr
    return None


def _check_hostsync(tree: ast.Module, path: str) -> Iterator[Finding]:
    owner = _owner(tree)
    seen: set[str] = set()
    for node in ast.walk(tree):
        fn = owner.get(id(node), "<module>")
        if fn == "<module>" or not _in_scope(path, fn):
            continue
        what = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("item", "tolist") and not node.args:
            what = f".{node.func.attr}()"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "bool" and node.args and _tensor_call(node.args[0]):
            what = "bool()"
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)) and _tensor_call(node.test):
            what = f"{type(node).__name__.lower()} on {_tensor_call(node.test)}(...)"
        if what is None:
            continue
        sym = f"{fn}:{what}"
        if sym in seen:
            continue
        seen.add(sym)
        yield Finding(RULE_HOSTSYNC, path, node.lineno, sym,
                      f"`{what}` in `{fn}` reads a tensor on the host: a sync on every "
                      "call of a kernel wrapper or per-rank body, and an error on a dry "
                      "run's fake tensors")


# ------------------------------------------------------------------ driver --
_CHECKS = (_check_import, _check_fallback, _check_hwconst, _check_placement_dup,
           _check_hostsync)


def lint_source(src: str, path: str) -> list[Finding]:
    """Every rule over one module's source; ``path`` is the repo-relative
    name used in the finding keys."""
    tree = ast.parse(src, filename=path)
    out: list[Finding] = []
    for check in _CHECKS:
        out.extend(check(tree, path))
    return out


def lint_paths(root: Path, rel_paths: Iterable[Path] | None = None) -> list[Finding]:
    """Lint ``rel_paths`` (default: every ``src/repro_torch/**/*.py``) under
    the checkout ``root``."""
    if rel_paths is None:
        rel_paths = sorted(p.relative_to(root)
                           for p in (root / "src" / "repro_torch").rglob("*.py"))
    findings: list[Finding] = []
    for rel in rel_paths:
        findings.extend(lint_source((root / rel).read_text(), Path(rel).as_posix()))
    return findings
