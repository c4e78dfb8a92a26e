"""AST lint: no host sync on a device value in the solve layers.

Counterpart of ``repro.analysis.lint``.  Where JAX raises
``ConcretizationTypeError`` on ``float(x)`` of a traced value, torch
answers at once: it copies the value to the host and waits for the device
(a host sync).  On a solve path that stalls the launch queue behind every
kernel before it, and a CUDA graph capture fails on it.  The lint flags
the calls that bring a tensor's value to the host, statically, in the
port's solve layers, where nearly every value may lie on the card:

  * JAX's calls: ``float(…)`` / ``int(…)`` on a non-literal argument,
    ``.item()`` and ``np.asarray(…)``;
  * torch's own: ``bool(…)`` on a non-literal, ``.tolist()``,
    ``.numpy()``, ``.cpu()`` and ``torch.cuda.synchronize(…)``.

Legitimate host-side sites (Python arguments, spec fields, environment
variables) carry the marker on the flagged line, with the reason in a
short comment::

    chunks = int(chunks)  # host int; speclint: allow-concretize

The marker is an audit trail: every such call in the solve layers is
either provably host-side (and says so) or a finding.  Calls whose
argument is a literal constant are not flagged.

An AST sees calls, not conversions: ``if (x > 0).any():`` reaches the
host through ``Tensor.__bool__`` with no call in the source.
``tracecheck``'s run-time leg (``nansweep.HostSyncMode`` over every
backend x mode, and ``torch.cuda.set_sync_debug_mode("error")`` on the
card) covers that class.
"""

from __future__ import annotations

import ast
import pathlib

from . import Finding

#: The marker that allowlists one line (put it on the line of the call).
ALLOW_MARKER = "speclint: allow-concretize"

#: Directories under src/repro_torch whose code runs on the solve path.
TRACED_PACKAGES = ("kernels", "solver", "models", "core")

_CAST_NAMES = ("float", "int", "bool")
_NUMPY_NAMES = ("np", "numpy")
#: Tensor methods that copy a value to the host.
_HOST_METHODS = ("item", "tolist", "numpy", "cpu")


def _is_static_arg(node) -> bool:
    """Literal constants (and unary +/- of them) never lie on a device."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    return False


def _dotted(node) -> str:
    """``torch.cuda.synchronize`` for that attribute chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _flag_of(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id in _CAST_NAMES:
        if node.args and not _is_static_arg(node.args[0]):
            return f"{fn.id}(...)"
        return None
    if isinstance(fn, ast.Attribute):
        if _dotted(fn) == "torch.cuda.synchronize":
            return "torch.cuda.synchronize(...)"
        if fn.attr in _HOST_METHODS and not node.args:
            return f".{fn.attr}()"
        if fn.attr == "asarray" and isinstance(fn.value, ast.Name) and \
                fn.value.id in _NUMPY_NAMES:
            return "np.asarray(...)"
    return None


def lint_source(text: str, filename: str = "<string>") -> list:
    """Lint one source text; returns findings."""
    out: list = []
    try:
        tree = ast.parse(text, filename=filename)
    except SyntaxError as exc:
        return [Finding("astlint", f"{filename}:{exc.lineno}",
                        f"syntax error: {exc.msg}")]
    lines = text.splitlines()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        flag = _flag_of(node)
        if flag is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if ALLOW_MARKER in line:
            continue
        out.append(Finding(
            "astlint", f"{filename}:{node.lineno}",
            f"{flag} brings a possibly on-device value to the host: the "
            f"call waits for the device (a host sync); keep it off the "
            f"solve path or mark the line with '# {ALLOW_MARKER}' and the "
            f"reason it is host-side"))
    return out


def run(root: str | None = None) -> list:
    """Lint every module of the solve packages."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(root)
    out: list = []
    for pkg in TRACED_PACKAGES:
        for path in sorted((root / pkg).rglob("*.py")):
            rel = path.relative_to(root.parent)
            out.extend(lint_source(path.read_text(), str(rel)))
    return out
