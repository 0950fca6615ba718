"""Runtime-contract rules: event-schema drift (the static half of the
telemetry schema guard), lock discipline for module-level state,
fault-injection site discipline and the CUDA-graph capture sites.

R005 parses ``utils/telemetry.py``'s ``EVENT_SCHEMAS`` literal out of the
AST (no import) and checks every literal ``telemetry.event("kind", ...)``
/ ``log_record(logger, "kind", ...)`` site in the package against it,
plus the frozen ``_V*_EVENT_KINDS`` back-compat sets.  The runtime guard
proves emitted events validate; this rule catches the drift *before*
anything runs, including kinds only emitted on rare paths.

R008 (same spirit as R005's schema drift): every LITERAL site name passed
to ``faultinject.site()`` / ``faultinject.truncate_fraction`` must be a key
of the one ``SITES`` table in ``utils/faultinject.py``, and each name must
be planted at exactly ONE call site — a typo'd or duplicated site name
silently never fires (or fires somewhere a chaos schedule didn't aim), and
nothing at runtime would ever notice.

R009 is the port's form of the JAX package's cache-bypass rule: there, an
inline AOT ``lower().compile()`` skips the program cache; here, a CUDA
graph captured outside the two capture sites skips what they do for every
graph (the warm-up under ``device_cond``'s both-branches hook, the premade
body streams, the launch counts and costs, the capture record).

Every rule takes its package's paths as arguments, so the same rules lint
another checkout or package.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator

from .callgraph import dotted, module_nodes
from .core import Finding, Rule, SourceModule

__all__ = ["SchemaDriftRule", "LockDisciplineRule", "FaultSiteRule",
           "CaptureSiteRule"]

_PKG = "qldpc_fault_tolerance_tpu_torch/"


# ---------------------------------------------------------------------------
# R005: static schema drift
# ---------------------------------------------------------------------------
# Frozen-set cardinality floors: the back-compat contract says these sets
# never shrink, so the analyzer pins the size each set had when frozen.
# Growing a set is a (wrong but different) finding: frozen sets are
# append-never, a new kind belongs to the CURRENT version only.
DEFAULT_FROZEN_FLOORS = {
    "_V1_EVENT_KINDS": 18,
    "_V2_EVENT_KINDS": 4,
    "_V3_EVENT_KINDS": 1,
    "_V4_EVENT_KINDS": 3,
    "_V5_EVENT_KINDS": 1,
    "_V6_EVENT_KINDS": 3,
    "_V7_EVENT_KINDS": 2,
}


class SchemaDriftRule(Rule):
    """Every literal event kind must exist in ``EVENT_SCHEMAS``; literal
    keyword emissions must carry the schema's required fields; the frozen
    version kind-sets stay subsets of the registry and never shrink."""

    id = "R005"
    title = "event kind / frozen schema drift"

    def __init__(self, frozen_floors: dict = None,
                 schema_module_rel: str = _PKG + "utils/telemetry.py"):
        self.frozen_floors = DEFAULT_FROZEN_FLOORS \
            if frozen_floors is None else frozen_floors
        self.schema_module_rel = schema_module_rel

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        registry = self._registry(ctx)
        if registry is None:
            return
        kinds, schemas = registry
        if module.rel == self.schema_module_rel:
            # the schema module gets the frozen-set checks AND the
            # emission checks below — telemetry.py emits events itself
            # (telemetry_enabled / snapshot / process_info)
            yield from self._check_frozen_sets(module, kinds)
        for node in module_nodes(module, ctx):
            if not isinstance(node, ast.Call):
                continue
            site = self._emission_kind(node)
            if site is None:
                continue
            kind, has_star = site
            if kind not in kinds:
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"event kind {kind!r} is not registered in "
                    f"EVENT_SCHEMAS — three consumers parse this stream; "
                    f"register the kind (and its fields) in "
                    f"utils/telemetry.py", node.col_offset)
                continue
            if has_star:
                continue  # **fields emission: runtime guard covers it
            required = schemas.get(kind, set())
            provided = {kw.arg for kw in node.keywords if kw.arg}
            missing = sorted(required - provided)
            if missing:
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"event {kind!r} emitted without required field(s) "
                    f"{missing} declared by EVENT_SCHEMAS",
                    node.col_offset)

    # -- registry extraction ----------------------------------------------
    def _registry(self, ctx):
        def build():
            mod = ctx.by_rel.get(self.schema_module_rel)
            if mod is None:
                return None
            kinds: set[str] = set()
            schemas: dict[str, set[str]] = {}
            for node in mod.tree.body:
                targets = []
                if isinstance(node, ast.Assign):
                    targets = [t.id for t in node.targets
                               if isinstance(t, ast.Name)]
                    value = node.value
                elif isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Name):
                    targets = [node.target.id]
                    value = node.value
                else:
                    continue
                if "EVENT_SCHEMAS" not in targets or \
                        not isinstance(value, ast.Dict):
                    continue
                for k, v in zip(value.keys, value.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        continue
                    kinds.add(k.value)
                    schemas[k.value] = self._required_fields(v)
            return (kinds, schemas) if kinds else None
        return ctx.cache(("event_registry", self.schema_module_rel), build)

    @staticmethod
    def _required_fields(schema_value: ast.AST) -> set[str]:
        if not isinstance(schema_value, ast.Dict):
            return set()
        for k, v in zip(schema_value.keys, schema_value.values):
            if isinstance(k, ast.Constant) and k.value == "required" and \
                    isinstance(v, ast.Dict):
                return {f.value for f in v.keys
                        if isinstance(f, ast.Constant)
                        and isinstance(f.value, str)}
        return set()

    # -- emission sites ----------------------------------------------------
    @staticmethod
    def _emission_kind(call: ast.Call):
        """(kind, has_star_kwargs) for telemetry.event / event /
        log_record calls with a literal kind; None otherwise."""
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            chain = dotted(func)
            # telemetry.event(...) only — an arbitrary obj.event() is not
            # an emission site
            if chain and chain[-1] == "event" and \
                    chain[0] in ("telemetry",):
                name = "event"
            elif func.attr == "log_record":
                name = "log_record"
        if name == "event" and call.args:
            kind_arg = call.args[0]
        elif name == "log_record" and len(call.args) >= 2:
            kind_arg = call.args[1]
        else:
            return None
        if not (isinstance(kind_arg, ast.Constant)
                and isinstance(kind_arg.value, str)):
            return None
        has_star = any(kw.arg is None for kw in call.keywords)
        return kind_arg.value, has_star

    # -- frozen sets (inside telemetry.py itself) -------------------------
    def _check_frozen_sets(self, module, kinds) -> Iterator[Finding]:
        frozen: dict[str, tuple[set, int]] = {}
        for node in module.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name not in self.frozen_floors:
                continue
            members = self._literal_str_set(node.value)
            if members is None:
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"{name} must stay a literal frozenset of kind "
                    f"strings so the analyzer (and readers) can read "
                    f"the contract", node.col_offset)
                continue
            frozen[name] = (members, node.lineno)

        for name, floor in sorted(self.frozen_floors.items()):
            if name not in frozen:
                yield Finding(
                    module.rel, 1, self.id,
                    f"frozen kind set {name} is missing from "
                    f"utils/telemetry.py — the back-compat contract "
                    f"lost its anchor")
                continue
            members, lineno = frozen[name]
            if len(members) < floor:
                yield Finding(
                    module.rel, lineno, self.id,
                    f"{name} shrank to {len(members)} kinds (frozen floor "
                    f"is {floor}) — frozen sets never lose members")
            for kind in sorted(members - kinds):
                yield Finding(
                    module.rel, lineno, self.id,
                    f"frozen kind {kind!r} in {name} has no EVENT_SCHEMAS "
                    f"entry — removing a schema breaks the back-compat "
                    f"guarantee")
        # pairwise disjoint
        names = sorted(frozen)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                overlap = frozen[a][0] & frozen[b][0]
                if overlap:
                    yield Finding(
                        module.rel, frozen[b][1], self.id,
                        f"kind(s) {sorted(overlap)} appear in both {a} "
                        f"and {b} — each kind freezes in exactly one "
                        f"version")

    @staticmethod
    def _literal_str_set(value: ast.AST):
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == "frozenset" and len(value.args) == 1:
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            out = set()
            for e in value.elts:
                if not (isinstance(e, ast.Constant)
                        and isinstance(e.value, str)):
                    return None
                out.add(e.value)
            return out
        return None


# ---------------------------------------------------------------------------
# R006: lock discipline
# ---------------------------------------------------------------------------
_MUTATORS = {"append", "add", "update", "extend", "insert", "pop",
             "remove", "clear", "setdefault", "discard", "popleft",
             "appendleft", "popitem"}
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}


class LockDisciplineRule(Rule):
    """Module-level mutable containers in ``serve/`` and ``utils/`` are
    shared across the server and engine threads; every write must happen
    under a module lock (``with _THE_LOCK:``) or live in a
    ``threading.local()``.  Immutable swaps (tuple snapshots) and
    import-time initialization are exempt by construction."""

    id = "R006"
    title = "unlocked write to module-level mutable state"

    DEFAULT_SCOPES = (_PKG + "serve/", _PKG + "utils/")

    def __init__(self, scopes: tuple = DEFAULT_SCOPES):
        self.scopes = scopes

    def applies(self, rel: str) -> bool:
        return any(rel.startswith(s) for s in self.scopes)

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        containers, locks = self._module_state(module)
        if not containers:
            return
        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                yield from self._check_writes(node, containers, locks,
                                              module, under_lock=False,
                                              global_names=set())

    @staticmethod
    def _module_state(module):
        """(mutable container names, lock names) assigned at module
        level.  threading.local() containers are exempt."""
        containers: set[str] = set()
        locks: set[str] = set()
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                name = node.target.id
            else:
                continue
            v = node.value
            if isinstance(v, (ast.List, ast.Dict, ast.Set)):
                containers.add(name)
            elif isinstance(v, ast.Call):
                chain = dotted(v.func)
                if not chain:
                    continue
                if chain[-1] in ("Lock", "RLock", "Condition",
                                 "Semaphore", "BoundedSemaphore"):
                    locks.add(name)
                elif chain[-1] == "local":
                    continue  # thread-local: registered, exempt
                elif chain[-1] in _CONTAINER_CTORS:
                    containers.add(name)
        return containers, locks

    def _check_writes(self, node, containers, locks, module,
                      *, under_lock, global_names) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            global_names = global_names | {
                name for stmt in node.body
                if isinstance(stmt, ast.Global) for name in stmt.names}
        if isinstance(node, ast.With):
            held = under_lock or any(
                isinstance(item.context_expr, ast.Name)
                and item.context_expr.id in locks
                for item in node.items)
            for child in node.body:
                yield from self._check_writes(
                    child, containers, locks, module, under_lock=held,
                    global_names=global_names)
            return
        written = self._written_container(node, containers, global_names)
        if written is not None and not under_lock:
            name, line, col = written
            yield Finding(
                module.rel, line, self.id,
                f"module-level mutable {name!r} written outside a "
                f"`with <lock>` block — wrap the write in the module "
                f"lock or make the state thread-local", col)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword, ast.arguments)):
                continue  # expressions handled via _written_container
            yield from self._check_writes(
                child, containers, locks, module, under_lock=under_lock,
                global_names=global_names)

    @staticmethod
    def _written_container(stmt, containers, global_names):
        """(name, line, col) when this single statement writes a tracked
        container: subscript/attr assignment, mutating method call, del,
        or a `global` rebind."""
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                root = t
                while isinstance(root, (ast.Subscript, ast.Attribute)):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in containers:
                    if root is t and isinstance(stmt, ast.Assign) and \
                            root.id not in global_names:
                        # plain `x = ...` without `global` just shadows
                        continue
                    return root.id, t.lineno, t.col_offset
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                root = t
                while isinstance(root, (ast.Subscript, ast.Attribute)):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in containers \
                        and root is not t:
                    return root.id, t.lineno, t.col_offset
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Attribute) and \
                stmt.value.func.attr in _MUTATORS and \
                isinstance(stmt.value.func.value, ast.Name) and \
                stmt.value.func.value.id in containers:
            return (stmt.value.func.value.id, stmt.lineno,
                    stmt.col_offset)
        if isinstance(stmt, ast.Global):
            return None  # the rebind itself is caught when it assigns
        return None


# ---------------------------------------------------------------------------
# R008: faultinject site discipline
# ---------------------------------------------------------------------------
class FaultSiteRule(Rule):
    """Every literal ``faultinject.site("name")`` /
    ``faultinject.truncate_fraction("name")`` must name a key of the one
    ``SITES`` table in utils/faultinject.py, each name must be planted at
    exactly one call site across the package, and every table entry must
    be planted somewhere — three ways a fault plan (or chaos schedule)
    could otherwise target a site that silently never fires.

    Dynamically-minted site names (``faultinject.site(site)`` with a
    variable, e.g. the engines' ``wer.<engine>`` sites) are deliberately
    out of scope: the rule constrains literals only."""

    id = "R008"
    title = "faultinject site not registered / not unique"

    SITE_FUNCS = ("site", "truncate_fraction")

    def __init__(self, site_module_rel: str = _PKG + "utils/faultinject.py"):
        self.site_module_rel = site_module_rel

    # -- the SITES table + the cross-module literal-use index --------------
    def _index(self, ctx):
        def build():
            mod = ctx.by_rel.get(self.site_module_rel)
            if mod is None:
                return None
            registered = self._sites_table(mod)
            if registered is None:
                return None
            uses: dict[str, list] = {}
            for module in ctx.modules:
                if getattr(module, "parse_error", None):
                    continue
                for node in module_nodes(module, ctx):
                    name = self._literal_site(node)
                    if name is not None:
                        uses.setdefault(name, []).append(
                            (module.rel, node.lineno, node.col_offset))
            for occ in uses.values():
                occ.sort()
            return registered, uses
        return ctx.cache(("fault_sites", self.site_module_rel), build)

    @staticmethod
    def _sites_table(mod: SourceModule):
        """{site name: lineno} parsed from the module-level SITES dict
        literal, or None when the anchor is missing/unreadable."""
        for node in mod.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets
                           if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                targets = [node.target.id]
                value = node.value
            else:
                continue
            if "SITES" not in targets or not isinstance(value, ast.Dict):
                continue
            table = {}
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    table[k.value] = k.lineno
            return table
        return None

    def _literal_site(self, node) -> "str | None":
        """The literal first argument of a faultinject.site /
        faultinject.truncate_fraction call (None for variables and
        unrelated calls)."""
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        chain = dotted(func)
        if not chain or chain[-1] not in self.SITE_FUNCS or \
                chain[0] != "faultinject":
            return None
        if not node.args:
            return None
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        return None

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        index = self._index(ctx)
        if index is None:
            return
        registered, uses = index
        if module.rel == self.site_module_rel:
            # stale table entries keep the registry honest: an entry no
            # call site plants means the failure point moved (or never
            # existed) and plans targeting it are dead weight
            for name, lineno in sorted(registered.items()):
                if name not in uses:
                    yield Finding(
                        module.rel, lineno, self.id,
                        f"site {name!r} is registered in SITES but no "
                        f"faultinject.site()/truncate_fraction() literal "
                        f"plants it — delete the entry or plant the site")
        for node in module_nodes(module, ctx):
            name = self._literal_site(node)
            if name is None:
                continue
            if name not in registered:
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"faultinject site {name!r} is not registered in the "
                    f"SITES table (utils/faultinject.py) — an unregistered "
                    f"name is one typo away from a fault plan that "
                    f"silently never fires", node.col_offset)
                continue
            first = uses[name][0]
            if (module.rel, node.lineno, node.col_offset) != first:
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"faultinject site {name!r} is also planted at "
                    f"{first[0]}:{first[1]} — one name maps to one failure "
                    f"point; mint a distinct site name for this call",
                    node.col_offset)


# ---------------------------------------------------------------------------
# R009: CUDA-graph capture sites
# ---------------------------------------------------------------------------
class CaptureSiteRule(Rule):
    """Every ``torch.cuda.CUDAGraph(...)`` / ``torch.cuda.graph(...)``
    belongs to one of two blessed functions: ``parallel/shots.py``
    ``_capture_graph`` (the megabatch graphs, which every engine, fused
    bucket, stream step and serve session captures through) and
    ``utils/device.py`` ``graph_capture`` (the capture context with
    ``device_cond``'s conditional nodes).  A graph captured anywhere else
    works, silently: it skips the warm-up under the both-branches hook,
    the premade body streams, the launch counts and the capture costs that
    the two sites give every graph.  Aliases (``import torch.cuda as
    tc``, ``from torch.cuda import CUDAGraph``) are followed."""

    id = "R009"
    title = "CUDA graph captured outside the blessed capture sites"

    DEFAULT_SITES = ((_PKG + "parallel/shots.py", "_capture_graph"),
                     (_PKG + "utils/device.py", "graph_capture"))
    _CAPTURE = ("CUDAGraph", "graph")

    def __init__(self, sites: tuple = DEFAULT_SITES,
                 package_prefix: str = _PKG):
        self.sites = sites
        self.package_prefix = package_prefix

    def applies(self, rel: str) -> bool:
        return rel.startswith(self.package_prefix)

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        blessed = {fn for rel, fn in self.sites if rel == module.rel}
        cuda_aliases, bare = self._bindings(module.tree)
        stack = [(module.tree, False)]
        while stack:
            node, inside = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inside = inside or node.name in blessed
            if not inside and isinstance(node, ast.Call) and \
                    self._is_capture(node.func, cuda_aliases, bare):
                yield Finding(
                    module.rel, node.lineno, self.id,
                    "CUDA graph captured outside parallel/shots.py "
                    "_capture_graph and utils/device.py graph_capture — "
                    "capture through them so the graph gets the warm-up, "
                    "the body streams and the launch counts",
                    node.col_offset)
            stack.extend((child, inside)
                         for child in ast.iter_child_nodes(node))

    @classmethod
    def _bindings(cls, tree):
        """(names bound to the ``torch.cuda`` module, bare names bound to
        its capture functions)."""
        cuda_aliases: set[str] = set()
        bare: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch.cuda" and a.asname:
                        cuda_aliases.add(a.asname)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if node.module == "torch.cuda" and \
                            a.name in cls._CAPTURE:
                        bare.add(a.asname or a.name)
                    elif node.module == "torch" and a.name == "cuda":
                        cuda_aliases.add(a.asname or a.name)
        return cuda_aliases, bare

    @classmethod
    def _is_capture(cls, func, cuda_aliases, bare) -> bool:
        chain = dotted(func)
        if not chain:
            return False
        if len(chain) == 1:
            return chain[0] in bare
        if chain[-1] not in cls._CAPTURE:
            return False
        return chain[-2] == "cuda" or (len(chain) == 2
                                       and chain[0] in cuda_aliases)
