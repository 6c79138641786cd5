"""Determinism lint: AST rules enforcing the seeded-RNG / virtual-clock /
stable-fingerprint discipline the plan cache, resume, and bench
reproducibility all assume.

Rules (the ``rule`` field of each :class:`Finding`):

=========================  =============================================
``unseeded-rng``           legacy global ``np.random.*`` draws, unseeded
                           ``np.random.default_rng()`` /
                           ``random.Random()``, and stdlib ``random.*``
                           draws — all derive state from an ambient
                           process-global seed
``wall-clock``             ``time.time()`` / ``perf_counter()`` /
                           ``datetime.now()`` reads inside virtual-clock
                           modules (``core/events.py``, ``core/netsim.py``)
                           and the obs layer — wall time leaking into
                           simulated results
``dict-order-in-``         iteration over ``set()`` / ``frozenset()`` /
``fingerprint``            dict views inside fingerprint/cache-key
                           functions without a ``sorted()`` wrapper —
                           ordering that depends on construction history
``fingerprint-coverage``   a ``ScenarioSpec`` field missing from
                           :data:`SPEC_FIELD_ROLES`, or a plan-identity
                           field not folded into the plan cache's
                           fingerprint/key functions
=========================  =============================================

Findings are suppressed by ``lint_allowlist.txt`` (beside this module)
lines of the form ``<path-suffix> <rule> <detail-substring>`` — every
intentional exception (the obs recorder's two wall-clock span timestamps)
is visible in one reviewed file instead of scattered pragmas.
``python -m repro_torch.verify --lint`` runs it over ``src/repro_torch/``
and fails on any unsuppressed finding.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: legacy numpy global-state draws (np.random.<fn>)
NP_RANDOM_FNS = frozenset({
    "random", "rand", "randn", "randint", "random_integers", "choice",
    "shuffle", "permutation", "normal", "uniform", "standard_normal",
    "binomial", "poisson", "exponential", "beta", "gamma", "sample",
    "random_sample", "bytes",
})

#: stdlib random module draws (random.<fn>) — seed()/getstate() are fine
STDLIB_RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "triangular", "vonmisesvariate",
})

#: wall-clock reads (time.<fn> / datetime.<fn>)
TIME_FNS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns",
})
DATETIME_FNS = frozenset({"now", "utcnow", "today"})

#: the port's reviewed allowlist, read relative to this module
ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "lint_allowlist.txt")

#: relative-path substrings of modules that run on *virtual* clocks (plus
#: the obs layer, whose few intentional wall reads live in the allowlist)
VIRTUAL_CLOCK_MODULES = ("core/events.py", "core/netsim.py", "obs/")

#: function names treated as fingerprint/cache-key builders by the
#: dict-order rule
FINGERPRINT_FN_RE = re.compile(
    r"(fingerprint|_field_tuple|policy_key|cache_key|_key)$")

#: every ScenarioSpec field, classified by what its value influences.
#: ``plan`` fields are the plan's cache identity and MUST be folded into
#: ``overlay_fingerprint``/``policy_key``; the coverage rule fails when a
#: new field is added without classifying it here (forcing the author to
#: decide whether it changes the plan) or when a ``plan`` field is missing
#: from the key functions.
SPEC_FIELD_ROLES: Dict[str, str] = {
    # plan identity -> must appear in cache.policy_key/overlay_fingerprint
    "overlay": "plan",
    "protocol": "plan",
    "n_segments": "plan",
    "mst_algorithm": "plan",
    "coloring_algorithm": "plan",
    "optimizer": "plan",
    # membership trajectory (cache.trajectory key)
    "rounds": "trajectory",
    "churn": "trajectory",
    # wire accounting (folded into the verified-stage key)
    "payload": "wire",
    "codec": "wire",
    # timing / underlay (cache.timing key via underlay_fingerprint)
    "underlay": "timing",
    "compute_time_s": "timing",
    "compute_jitter_s": "timing",
    "jitter_seed": "timing",
    "max_staleness": "timing",
    # per-run runtime behaviour, deliberately not plan identity
    "drop_rate": "runtime",
    "drop_seed": "runtime",
    "record_events": "runtime",
    "require": "runtime",
    "executors": "runtime",
    # documentation only
    "name": "doc",
    "description": "doc",
}


@dataclass
class Finding:
    """One lint hit, printable as ``path:line: [rule] detail``."""

    path: str
    line: int
    rule: str
    detail: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.detail}"


def _module_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local names to the canonical module they alias (``np`` ->
    ``numpy``, ``random`` -> ``random``, ``npr`` -> ``numpy.random``)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("numpy", "numpy.random", "random", "time",
                              "datetime"):
                    aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module == "numpy":
            for a in node.names:
                if a.name == "random":
                    aliases[a.asname or "random"] = "numpy.random"
        elif isinstance(node, ast.ImportFrom) and node.module == "datetime":
            for a in node.names:
                if a.name == "datetime":
                    aliases[a.asname or "datetime"] = "datetime.datetime"
    return aliases


def _resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted module path of an expression like ``np.random`` / ``time``."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    if isinstance(node, ast.Attribute):
        base = _resolve(node.value, aliases)
        if base is not None:
            return f"{base}.{node.attr}"
    return None


def _check_rng(tree: ast.AST, rel: str, aliases: Dict[str, str],
               out: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        base = _resolve(fn.value, aliases)
        if base == "numpy.random":
            if fn.attr in NP_RANDOM_FNS:
                out.append(Finding(
                    rel, node.lineno, "unseeded-rng",
                    f"legacy global np.random.{fn.attr}() draws from "
                    f"process-global state; use np.random.default_rng(seed)"))
            elif fn.attr == "default_rng" and not node.args:
                out.append(Finding(
                    rel, node.lineno, "unseeded-rng",
                    "np.random.default_rng() without a seed is entropy-"
                    "seeded; pass an explicit seed"))
            elif fn.attr in ("RandomState", "seed") and not node.args:
                out.append(Finding(
                    rel, node.lineno, "unseeded-rng",
                    f"np.random.{fn.attr}() without a seed"))
        elif base == "random":
            if fn.attr in STDLIB_RANDOM_FNS:
                out.append(Finding(
                    rel, node.lineno, "unseeded-rng",
                    f"stdlib random.{fn.attr}() draws from process-global "
                    f"state; use random.Random(seed)"))
            elif fn.attr == "Random" and not node.args:
                out.append(Finding(
                    rel, node.lineno, "unseeded-rng",
                    "random.Random() without a seed is entropy-seeded"))


def _check_wall_clock(tree: ast.AST, rel: str, aliases: Dict[str, str],
                      out: List[Finding]) -> None:
    if not any(tag in rel for tag in VIRTUAL_CLOCK_MODULES):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        base = _resolve(fn.value, aliases)
        if base == "time" and fn.attr in TIME_FNS:
            out.append(Finding(
                rel, node.lineno, "wall-clock",
                f"time.{fn.attr}() read inside a virtual-clock module"))
        elif base is not None and base.endswith("datetime") and \
                fn.attr in DATETIME_FNS:
            out.append(Finding(
                rel, node.lineno, "wall-clock",
                f"datetime.{fn.attr}() read inside a virtual-clock module"))


def _iter_exprs_of(fn: ast.AST):
    """(line, iter-expression) of every for-loop / comprehension in a
    function body, excluding nested function definitions."""
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            yield node.lineno, node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield node.lineno, gen.iter


def _unordered_iter(expr: ast.AST) -> Optional[str]:
    """A description of why iterating ``expr`` has unstable order, or
    ``None``. ``sorted(...)`` at the top level always makes it stable."""
    if not isinstance(expr, ast.Call):
        return None
    fn = expr.func
    if isinstance(fn, ast.Name):
        if fn.id in ("set", "frozenset"):
            return f"iterates {fn.id}(...) (hash order)"
        return None  # sorted(...), tuple(...), list(...), enumerate(...)
    if isinstance(fn, ast.Attribute) and fn.attr in ("keys", "values",
                                                     "items"):
        return (f"iterates .{fn.attr}() (insertion order — depends on "
                f"construction history)")
    return None


def _check_fingerprint_order(tree: ast.AST, rel: str,
                             out: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not FINGERPRINT_FN_RE.search(node.name):
            continue
        for line, it in _iter_exprs_of(node):
            why = _unordered_iter(it)
            if why is not None:
                out.append(Finding(
                    rel, line, "dict-order-in-fingerprint",
                    f"fingerprint function {node.name}() {why}; wrap in "
                    f"sorted(...)"))


def _spec_fields(spec_path: str) -> Tuple[int, List[str]]:
    """(class line, annotated field names) of ScenarioSpec, by pure AST —
    the lint never imports the tree it checks."""
    with open(spec_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=spec_path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "ScenarioSpec":
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            return node.lineno, fields
    return 0, []


def _key_fn_spec_attrs(cache_path: str) -> Set[str]:
    """Every ``spec.<attr>`` access inside the plan-identity key builders
    (``_base_overlay_fingerprint`` / ``overlay_fingerprint`` /
    ``policy_key``) of scenario/cache.py."""
    with open(cache_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=cache_path)
    attrs: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if node.name not in ("_base_overlay_fingerprint",
                             "overlay_fingerprint", "policy_key"):
            continue
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "spec"):
                attrs.add(sub.attr)
    return attrs


def check_fingerprint_coverage(root: str) -> List[Finding]:
    """The semantic half of the lint: every ``ScenarioSpec`` field must be
    classified in :data:`SPEC_FIELD_ROLES`, and every ``plan``-role field
    must actually be folded into the plan cache's fingerprint/key
    functions. Catches the classic cache-poisoning bug — a new spec field
    that changes the plan but not its cache key."""
    spec_path = os.path.join(root, "scenario", "spec.py")
    cache_path = os.path.join(root, "scenario", "cache.py")
    if not (os.path.exists(spec_path) and os.path.exists(cache_path)):
        return []  # not linting the package tree (e.g. a test fixture dir)
    out: List[Finding] = []
    line, fields = _spec_fields(spec_path)
    rel = os.path.join(os.path.basename(root), "scenario", "spec.py")
    for f in fields:
        if f not in SPEC_FIELD_ROLES:
            out.append(Finding(
                rel, line, "fingerprint-coverage",
                f"ScenarioSpec.{f} is not classified in SPEC_FIELD_ROLES; "
                f"decide whether it changes the compiled plan and add it"))
    for f in sorted(set(SPEC_FIELD_ROLES) - set(fields)):
        out.append(Finding(
            rel, line, "fingerprint-coverage",
            f"SPEC_FIELD_ROLES names {f!r} which is no longer a "
            f"ScenarioSpec field"))
    keyed = _key_fn_spec_attrs(cache_path)
    crel = os.path.join(os.path.basename(root), "scenario", "cache.py")
    for f in sorted(fn for fn, role in SPEC_FIELD_ROLES.items()
                    if role == "plan" and fn in fields):
        if f not in keyed:
            out.append(Finding(
                crel, 1, "fingerprint-coverage",
                f"plan-identity field spec.{f} is not folded into "
                f"overlay_fingerprint/policy_key — cache entries can "
                f"collide across values of {f!r}"))
    return out


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    """All per-file rule findings for one Python source file."""
    rel = (rel or path).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    aliases = _module_aliases(tree)
    out: List[Finding] = []
    _check_rng(tree, rel, aliases, out)
    _check_wall_clock(tree, rel, aliases, out)
    _check_fingerprint_order(tree, rel, out)
    return out


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` plus the cross-file fingerprint
    coverage check. Paths in findings are relative to ``root``'s parent
    (``src/repro_torch/... -> repro_torch/...``)."""
    root = os.path.abspath(root)
    base = os.path.dirname(root)
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            findings.extend(lint_file(path, os.path.relpath(path, base)))
    findings.extend(check_fingerprint_coverage(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def load_allowlist(path: str) -> List[Tuple[str, str, str]]:
    """Parse allowlist lines: ``<path-suffix> <rule> <detail-substring>``
    (blank lines and ``#`` comments skipped)."""
    entries: List[Tuple[str, str, str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 2)
            if len(parts) != 3:
                raise ValueError(
                    f"{path}: malformed allowlist line {line!r} "
                    f"(want: <path-suffix> <rule> <detail-substring>)")
            entries.append((parts[0], parts[1], parts[2]))
    return entries


def filter_allowed(findings: Sequence[Finding],
                   allow: Sequence[Tuple[str, str, str]]) -> List[Finding]:
    """Drop findings matched by an allowlist entry."""
    out = []
    for f in findings:
        if not any(f.path.endswith(suffix) and f.rule == rule
                   and sub in f.detail
                   for suffix, rule, sub in allow):
            out.append(f)
    return out
