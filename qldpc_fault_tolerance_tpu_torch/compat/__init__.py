"""Drop-in shims for the reference module names.

``install()`` registers the reference's module names in ``sys.modules`` so
notebook code written against the reference repo runs unmodified on the
port:

    import qldpc_fault_tolerance_tpu_torch.compat as compat
    compat.install(device="cuda")
    from Simulators import CodeFamily            # reference src/Simulators.py
    from Decoders import BPOSD_Decoder_Class     # reference src/Decoders.py

Notebook code never passes a device, and every entry point of the port takes
one.  ``install`` takes it once and binds it into every class the shims and
stubs expose that takes a ``device``: decoders, decoder classes, engines,
families and ``ldpc.bp_decoder``.  A bound class is a
subclass of the port's class of the same name, so ``isinstance`` against the
port's own classes holds.  ``"cuda"`` with no card raises at the first
construction, as every port entry point does.

When the real ``ldpc`` / ``bposd`` / ``stim`` packages are absent (they are
not dependencies of the port), lightweight stand-ins expose the handful of
entry points the notebooks touch (``ldpc.codes.rep_code/ring_code``,
``ldpc.mod2.rank``, ``ldpc.code_util.compute_code_distance``,
``bposd.hgp.hgp``, ``stim.Circuit``) backed by the port's codes/ and
circuits/ layers.  A reference name or stub that another package's compat
layer registered (the JAX package's, in a process that installed both) is
treated as absent and replaced, so notebook code never runs that package.

``notebook_cells``, ``notebook_header`` and ``run_cell`` run a notebook's
code cells as a notebook does, and report the (failures, shots) of every
engine run in a cell.
"""
from __future__ import annotations

import ast
import functools
import importlib
import inspect
import json
import sys
import types

__all__ = ["install", "notebook_cells", "notebook_header",
           "reference_modules", "run_cell", "third_party_stubs"]

_REFERENCE_MODULES = (
    "Simulators",
    "Simulators_SpaceTime",
    "Decoders",
    "Decoders_SpaceTime",
    "ErrorPlugin",
    "CircuitScheduling",
    "QuantumExanderCodesGene",
    "par2gen",
)
_OWNER = __name__.split(".")[0]
# packages whose compat layers register shims under the reference names
_SHIM_PACKAGES = frozenset({_OWNER, "qldpc_fault_tolerance_tpu"})
_THIRD_PARTY = ("ldpc", "bposd", "stim", "graph_tools")
_BOUND: dict = {}


def install(include_third_party_stubs: bool = True, device="cuda") -> None:
    """Register the reference names (and, by default, the third-party
    stubs and the ``loadmat`` redirect), every device-taking entry point
    bound to ``device``.  A reference name already held by a module that
    is no shim stays, and a real third-party package wins over its stub;
    installing again rebinds."""
    for name, mod in reference_modules(device).items():
        held = sys.modules.get(name)
        if held is None or _is_shim(held):
            sys.modules[name] = mod

    if include_third_party_stubs:
        stubs = third_party_stubs(device)
        for top in _THIRD_PARTY:
            if _absent(top):
                sys.modules.update((name, mod) for name, mod in stubs.items()
                                   if name.split(".")[0] == top)
        _install_loadmat_redirect()


def reference_modules(device="cuda") -> dict:
    """The eight reference-name modules, device bound, without touching
    ``sys.modules``: ``{name: module}``."""
    out = {}
    for name in _REFERENCE_MODULES:
        src = importlib.import_module(f".{name}", __name__)
        mod = types.ModuleType(name, src.__doc__)
        mod.__qldpc_stub__ = _OWNER
        mod.__all__ = list(src.__all__)
        for attr in src.__all__:
            setattr(mod, attr, _bind(getattr(src, attr), device))
        out[name] = mod
    return out


def notebook_cells(path) -> list:
    """The code cells of a notebook file, each as one string.  (In the
    executed notebooks under ``examples/executed/``, cell 0 installs the
    JAX package's compat layer and cell 1 holds the imports.)"""
    with open(path, encoding="utf-8") as fh:
        nb = json.load(fh)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def notebook_header(cells: list) -> str:
    """Cell 1, the notebook's imports (the stubs among them), without
    matplotlib and networkx, which the port does not need."""
    return "\n".join(line for line in cells[1].splitlines()
                     if "matplotlib" not in line and "networkx" not in line)


def run_cell(src: str, ns: dict, diagnostics=None):
    """Run a notebook cell in ``ns`` as a notebook does: its statements,
    then the value of a trailing expression (the cell's output).  Returns
    that value and the (failures, shots) of every engine run in the cell,
    as the engines report them to ``diagnostics.cell_scope`` (the port's
    ``utils.diagnostics`` unless another module of its interface is
    given)."""
    if diagnostics is None:
        from ..utils import diagnostics
    tree = ast.parse(src)
    last = tree.body.pop() if tree.body and \
        isinstance(tree.body[-1], ast.Expr) else None
    diagnostics.enable()
    try:
        with diagnostics.cell_scope() as box:
            exec(compile(tree, "<cell>", "exec"), ns)
            out = None if last is None else eval(
                compile(ast.Expression(last.value), "<cell>", "eval"), ns)
    finally:
        diagnostics.auto()
    return out, list(box.runs)


def _top(name) -> str:
    return (name if isinstance(name, str) else "").split(".")[0]


def _is_shim(mod) -> bool:
    """A module some package's compat layer registered: it carries the
    ``__qldpc_stub__`` marker, lives in one of those packages, or (a
    stand-in built without the marker, as the JAX package's ``stim`` and
    ``graph_tools`` are) was made by no import and holds their objects."""
    if getattr(mod, "__qldpc_stub__", False) or \
            _top(getattr(mod, "__name__", None)) in _SHIM_PACKAGES:
        return True
    return getattr(mod, "__spec__", None) is None and any(
        _top(getattr(v, "__module__", None)) in _SHIM_PACKAGES
        for v in vars(mod).values())


def _absent(name: str) -> bool:
    """True when ``name`` is free for a shim: not importable, or taken by
    a shim (ours or another package's).  A real module wins."""
    mod = sys.modules.get(name)
    if mod is not None:
        return _is_shim(mod)
    try:
        importlib.import_module(name)
    except ImportError:
        return True
    return _is_shim(sys.modules.get(name))


def _bind(obj, device):
    """``obj`` with ``device`` as the default of its ``device`` argument: a
    subclass of the same name for a class whose ``__init__`` takes one,
    made once a (class, device); ``obj`` itself otherwise.  (No function
    the shims expose takes a device.)"""
    key = (obj, str(device))
    if key in _BOUND:
        return _BOUND[key]
    if not isinstance(obj, type):
        return obj
    try:
        params = inspect.signature(obj.__init__).parameters
    except (TypeError, ValueError):
        return obj
    if "device" not in params:
        return obj
    base_init = obj.__init__
    # its place among the arguments after self; None where it is keyword-only
    pos = (list(params).index("device") - 1
           if params["device"].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
           else None)

    @functools.wraps(base_init)  # the signature stays the port's
    def __init__(self, *args, **kwargs):
        if "device" not in kwargs and (pos is None or len(args) <= pos):
            kwargs["device"] = device
        base_init(self, *args, **kwargs)

    bound = _BOUND[key] = type(obj.__name__, (obj,), {
        "__init__": __init__, "__module__": obj.__module__,
        "__qualname__": obj.__qualname__, "__doc__": obj.__doc__,
        "__qldpc_device__": device})
    return bound


def _install_loadmat_redirect() -> None:
    """Route ``scipy.io.loadmat`` through the author-path redirection.

    The checkpoint notebooks call ``loadmat`` directly on absolute paths
    from the author's laptop (Single-Shot cells 16/21, Threshold cells
    7/8); the basenames (LP_*.mat, GenBicycleA*.mat) exist in the
    reference codes_lib/.  Scoped to those known notebook basename patterns
    so a genuinely missing/mistyped user path still raises, and each
    redirect emits a one-line warning.  Idempotent; another package's
    redirect is replaced (the original is ``scipy.io.matlab.loadmat``);
    leaves existing paths untouched."""
    import fnmatch
    import os
    import warnings

    import scipy.io as sio
    import scipy.io.matlab

    current = sio.loadmat
    tag = getattr(current, "__qldpc_redirect__", False)
    if tag == _OWNER:
        return
    orig = scipy.io.matlab.loadmat if tag else current
    ref_lib = os.environ.get("QLDPC_REF_CODES_LIB",
                             "/root/reference/codes_lib")
    known_patterns = ("LP_*.mat", "GenBicycleA*.mat")

    def loadmat(file_name, *args, **kwargs):
        if isinstance(file_name, str) and not os.path.exists(file_name):
            base = os.path.basename(file_name)
            if any(fnmatch.fnmatch(base, pat) for pat in known_patterns):
                cand = os.path.join(ref_lib, base)
                if os.path.exists(cand):
                    warnings.warn(
                        f"compat: loadmat({file_name!r}) redirected to {cand}",
                        stacklevel=2,
                    )
                    file_name = cand
        return orig(file_name, *args, **kwargs)

    loadmat.__qldpc_redirect__ = _OWNER
    loadmat.__wrapped__ = orig
    sio.loadmat = loadmat


def third_party_stubs(device="cuda") -> dict:
    """The stand-ins for ``ldpc``, ``bposd``, ``stim`` and ``graph_tools``
    and their submodules, device bound, without touching ``sys.modules``:
    ``{module name: module}``.

    ``stim``: the notebooks ``import stim`` at the top; every actual use
    goes through the library layer (circuit IR + Pauli-frame sampler +
    DEM), so the stub only needs the construction surface.
    ``graph_tools``: ``from graph_tools import Graph`` appears in every
    notebook header; Graph is never used afterwards."""
    from ..circuits import Circuit, target_rec
    from ..codes import CssCode, classical_code_distance, gf2, hgp, \
        rep_code, ring_code
    from ..decoders import BPDecoder, BPOSD_Decoder

    class Graph:  # pragma: no cover - never exercised by the notebooks
        pass

    out = {}

    def stub(name, **attrs):
        mod = types.ModuleType(name)
        mod.__qldpc_stub__ = _OWNER  # marks function-valued stand-ins for pickle
        for k, v in attrs.items():
            setattr(mod, k, v)
        out[name] = mod
        return mod

    stub("ldpc",
         bp_decoder=_bind(BPDecoder, device),  # ctor keywords + .decode
         codes=stub("ldpc.codes", rep_code=rep_code, ring_code=ring_code),
         mod2=stub("ldpc.mod2", rank=gf2.rank, nullspace=gf2.nullspace,
                   row_basis=gf2.row_basis),
         code_util=stub("ldpc.code_util",
                        compute_code_distance=classical_code_distance))
    stub("bposd",
         bposd_decoder=_bind(BPOSD_Decoder, device),  # ctor keywords + .decode
         hgp=stub("bposd.hgp", hgp=hgp),
         css=stub("bposd.css", css_code=CssCode),
         # imported but unused by the notebooks
         css_decode_sim=stub("bposd.css_decode_sim", css_decode_sim=None))
    stub("stim", Circuit=Circuit, target_rec=target_rec)
    stub("graph_tools", Graph=Graph)
    return out
