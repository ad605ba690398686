"""Query planning + execution engine (§5, Fig. 7).

Pipeline: parse (repro_torch.core.sql) -> plan (encode literals into the GD
pre-processed domain, §5.1; consolidate same-column groups = "delayed
transformation", §5.2) -> weightings (§5.3) -> aggregate (§5.4) ->
de-preprocess results.

Value-domain aggregations (SUM/AVG/MIN/MAX/MEDIAN/VAR) run on the *decoded*
per-bin value metadata (affine inverse of pre-processing preserves ordering),
so Table 3's bound formulas apply directly in the raw domain.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import aggregate as agg
from repro_torch.core import coverage as covlib
from repro_torch.core import sql as sqlmod
from repro_torch.core import weightings as wlib
from repro_torch.core.types import PairwiseHist


@dataclasses.dataclass
class QueryResult:
    estimate: float | None
    lower: float | None
    upper: float | None
    groups: dict | None = None       # GROUP BY: value -> (est, lo, hi)
    latency_s: float = 0.0
    # Opt-in EXPLAIN breakdown (server-side tracing): per-stage ms tiling
    # the submit->resolve wall clock, plus cache/wave flags. None unless
    # the serving layer traced this query; cached results stay explain-free
    # (the breakdown describes ONE submission, not the shared value).
    explain: dict | None = None

    # Overridden by AdmissionRejected; lets clients branch on res.rejected
    # without an isinstance import.
    rejected = False
    # Overridden by QueryError / DeadlineExceeded (same pattern): failure
    # containment resolves futures with typed results, never hangs them.
    failed = False
    expired = False

    def as_tuple(self):
        return (self.estimate, self.lower, self.upper)


@dataclasses.dataclass
class AdmissionRejected(QueryResult):
    """Typed overload outcome: the serving layer declined to execute.

    Shares the ``QueryResult`` shape (``estimate``/``lower``/``upper`` are
    ``None``) so streaming clients that read fields never crash on an
    overload decision, and resolves the query's future as a *result*, not an
    exception — shedding is a policy outcome, not a failure. ``reason`` is
    ``"reject"`` (this query was turned away at a full queue) or
    ``"shed_oldest"`` (this query was evicted from the queue to admit a
    newer one); ``queue_depth`` is the depth observed at decision time.
    """

    estimate: float | None = None
    lower: float | None = None
    upper: float | None = None
    reason: str = "reject"
    queue_depth: int = 0

    rejected = True


@dataclasses.dataclass
class QueryError(QueryResult):
    """Typed execution-failure outcome (mirrors ``AdmissionRejected``).

    Resolves the query's future as a *result* rather than an exception so
    a wave-level crash, a poison query, or a quarantined statement can
    never hang or kill streaming clients that only read fields. ``kind``
    is ``"execution"`` (the wave raised while running this query; it was
    retried once before giving up) or ``"quarantined"`` (the statement was
    refused up front because it already failed execution twice).
    ``retries`` counts execution attempts consumed; ``error`` carries the
    underlying exception text.
    """

    estimate: float | None = None
    lower: float | None = None
    upper: float | None = None
    error: str = ""
    kind: str = "execution"
    retries: int = 0

    failed = True


@dataclasses.dataclass
class DeadlineExceeded(QueryResult):
    """Typed deadline outcome: the query expired before execution.

    A query submitted with ``deadline_ms`` whose deadline passes while it
    is still queued skips the fused launch entirely and resolves with this
    result at the start of the next wave. ``deadline_ms`` echoes the
    budget; ``elapsed_ms`` is submit-to-resolution wall clock.
    """

    estimate: float | None = None
    lower: float | None = None
    upper: float | None = None
    deadline_ms: float = 0.0
    elapsed_ms: float = 0.0

    expired = True


class PlanError(ValueError):
    pass


def tree_key(tree) -> str:
    """Deterministic serialization of an encoded predicate tree.

    Used as the canonical-identity component of plan/leaf cache keys: two
    trees with equal structure, columns, ops and encoded literals produce the
    same key regardless of the SQL text they were parsed from. ``None``
    (no WHERE) serializes to ``"T"``.
    """
    if tree is None:
        return "T"
    if isinstance(tree, wlib.Leaf):
        return f"L({tree.col},{tree.op},{tree.value!r})"
    if isinstance(tree, wlib.Consolidated):
        ivs = ",".join(f"[{lo!r},{hi!r}]" for lo, hi in tree.intervals)
        return f"C({tree.col},{ivs})"
    children = ";".join(tree_key(ch) for ch in tree.children)
    return f"N({tree.kind}:{children})"


@dataclasses.dataclass
class QueryPlan:
    """A planned query: encoded/consolidated predicate tree + resolved columns.

    Plans depend only on the SQL text and the synopsis metadata (column
    encodings, consolidation grids), not on the histogram counts, so they are
    reusable across executions and cacheable by the serving layer as long as
    the synopsis generation ("epoch") is unchanged.

    GROUP BY plans are expanded at planning time into per-category **leaf
    plans** (``leaf_plans``): leaf ``i`` is the same aggregation with the
    predicate ``group_col = code_i`` AND-ed onto the WHERE tree and
    ``group_by=None``. All leaves of a GROUP BY share one batch-execution
    plan shape, so the serving scheduler can run every leaf of every
    in-flight GROUP BY as part of one fused ``batched_weightings`` launch;
    ``group_values[i]`` is the decoded category value leaf ``i`` reports
    under.
    """

    func: str                 # aggregation function
    agg_col: int | None       # None for COUNT(*)
    tree: object              # Leaf | Consolidated | Node | None
    group_by: int | None
    table: str | None = None  # FROM clause (resolved by the serving catalog)
    exec_col: int | None = None  # column whose weightings drive execution
    # GROUP BY expansion (populated by plan_query for categorical group_by).
    leaf_plans: tuple = ()    # tuple[QueryPlan]: per-category leaf plans
    group_values: tuple = ()  # decoded category values aligned with leaf_plans
    # Memoized canonical_key (the serving layer calls it on every cache
    # lookup; the tree never mutates after planning, so stringify once).
    _ckey: str | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def canonical_key(self) -> str:
        """Text-independent identity of this plan's *semantics*.

        Two plans compare equal iff they run the same aggregation over the
        same encoded predicate tree — regardless of the SQL text they came
        from (clause order, whitespace, redundant parentheses). The serving
        layer keys per-leaf result-cache entries on this, so overlapping
        GROUP BY queries (and textual variants of one query) share entries.
        Memoized: the predicate tree is frozen after planning.
        """
        if self._ckey is None:
            self._ckey = (f"{self.table}|{self.func}|{self.agg_col}|"
                          f"{self.group_by}|{tree_key(self.tree)}")
        return self._ckey

    def and_leaves(self):
        """Leaves of a pure-AND tree, or None (OR / no WHERE)."""
        if self.tree is None:
            return None
        return wlib.flat_and_leaves(self.tree)

    def shape_key(self):
        """Batch-execution plan shape: (exec_col, sorted pair-predicate cols).

        Queries sharing a shape key can execute as one fused batched kernel
        launch (the padded H/fold stacks depend only on the column set).
        Returns None when this plan is not batchable: GROUP BY, no WHERE,
        OR/nested trees, or duplicate pair-column leaves.
        """
        if self.group_by is not None or self.exec_col is None:
            return None
        leaves = self.and_leaves()
        if leaves is None:
            return None
        pair_cols = set()
        for leaf in leaves:
            if leaf.col == self.exec_col:
                continue
            if leaf.col in pair_cols:   # un-consolidated duplicate: fall back
                return None
            pair_cols.add(leaf.col)
        return (self.exec_col, tuple(sorted(pair_cols)))


def assemble_groups(plan: QueryPlan, leaf_results: dict) -> QueryResult:
    """Per-leaf ``QueryResult``s -> one GROUP BY ``QueryResult``.

    ``leaf_results`` maps leaf index -> result. Matches the sequential
    ``_group_by`` contract exactly: a category appears in ``groups`` iff its
    estimate is non-null and positive. Shared by the engine's own leaf path
    and the serving layer (which supplies leaf results from the batched
    kernel launch and the per-leaf result cache).
    """
    groups = {}
    for i, value in enumerate(plan.group_values):
        res = leaf_results.get(i)
        if res is not None and res.estimate is not None and res.estimate > 0:
            groups[value] = res.as_tuple()
    return QueryResult(None, None, None, groups=groups)


# ---------------------------------------------------------------------------
# Plan templates (zero-parse fast path)
# ---------------------------------------------------------------------------
#
# A compiled recipe for one query *shape* (literal-stripped fingerprint).
# The key fact making this sound: the consolidated tree STRUCTURE is
# literal-independent — ``_consolidate`` merges leaves by column
# multiplicity and orders children (merged-by-first-occurrence, then
# non-leaf rest) without ever looking at a literal value.  Only Leaf
# values and Consolidated interval *contents* vary between two queries of
# the same shape, so a recipe tree with literal-slot indices can bind any
# literal vector of that shape into a plan bit-for-bit equal to the cold
# ``parse_sql`` -> ``plan_query`` path.

@dataclasses.dataclass
class _SlotLeaf:
    """Recipe for a ``Leaf``: encoded literal comes from slot ``slot``."""
    col: int
    op: str
    slot: int


@dataclasses.dataclass
class _SlotMerge:
    """Recipe for a ``Consolidated``: re-runs the same interval merge that
    ``_consolidate`` performed at compile, over the new slot values."""
    col: int
    kind: str                  # "and" | "or" of the merging parent node
    parts: list                # [(op, slot), ...] in leaf order
    mu: float


@dataclasses.dataclass
class _SlotNode:
    """Recipe for a ``Node``: children already recipe nodes, in order."""
    kind: str
    children: list


class PlanTemplate:
    """Compiled planner for one query shape: binds literals -> ``QueryPlan``.

    Compiled once per (shape, epoch) from a cold parse+plan; after that,
    ``bind`` produces plans without touching ``parse_sql``/``plan_query``.
    ``bind_batch`` encodes the literal vectors of a whole wave in one numpy
    pass (all-numeric shapes), then assembles the per-query trees.
    """

    def __init__(self, engine: "QueryEngine", parsed: sqlmod.ParsedQuery):
        ph = engine.ph
        self._engine = engine
        self.func = parsed.func
        self.table = parsed.table
        self.agg_col = (None if parsed.agg_col == "*"
                        else ph.col_index(parsed.agg_col))
        self.group_by = (None if parsed.group_by is None
                         else ph.col_index(parsed.group_by))
        self._slot_cols: list[int] = []       # slot -> column index
        slot_tree = self._compile_encode(parsed.where)
        self.recipe = self._compile_consolidate(slot_tree)
        self.n_slots = len(self._slot_cols)
        self._columns = [ph.columns[c] for c in self._slot_cols]
        # Vectorized-encode constants (numeric shapes only; categorical
        # slots need .index() per literal, so they take the scalar path).
        self.numeric_only = all(c.kind != "categorical" for c in self._columns)
        if self.numeric_only and self.n_slots:
            self._scales = np.array([c.scale for c in self._columns])
            self._offsets = np.array([c.offset for c in self._columns])
        # exec_col depends only on the column set -> compile-time constant.
        self.exec_col = self.agg_col
        if self.agg_col is None and self.recipe is not None:
            self.exec_col = min(self._recipe_cols(self.recipe, set()))
        # GROUP BY expansion constants: category leaves, values, and the
        # (invariant) per-leaf exec_col, computed once at compile.
        if self.group_by is not None:
            col = ph.columns[self.group_by]
            if col.kind != "categorical":
                raise PlanError(
                    f"GROUP BY requires a categorical column, got {col.name!r}")
            self.cat_leaves = tuple(
                wlib.Leaf(self.group_by, "=", float(code))
                for code in range(len(col.categories)))
            self.group_values = tuple(col.categories)
            self.leaf_exec_col = self.agg_col
            if self.agg_col is None:
                cols = (self._recipe_cols(self.recipe, set())
                        if self.recipe is not None else set())
                cols.add(self.group_by)
                self.leaf_exec_col = min(cols)

    # ------------------------------------------------------------- compile

    def _compile_encode(self, raw):
        """Mirror of ``_encode``: RawCond -> _SlotLeaf, slots in token order
        (the parser emits RawConds left-to-right, child order preserved)."""
        if raw is None:
            return None
        if isinstance(raw, sqlmod.RawCond):
            slot = len(self._slot_cols)
            self._slot_cols.append(self._engine.ph.col_index(raw.col))
            return _SlotLeaf(self._slot_cols[slot], raw.op, slot)
        return _SlotNode(raw.kind,
                         [self._compile_encode(ch) for ch in raw.children])

    def _compile_consolidate(self, node):
        """Mirror of ``_consolidate`` over slot nodes: same grouping, same
        child order, values replaced by slot references."""
        if node is None or isinstance(node, _SlotLeaf):
            return node
        children = [self._compile_consolidate(ch) for ch in node.children]
        by_col: dict[int, list] = {}
        rest = []
        for ch in children:
            if isinstance(ch, _SlotLeaf):
                by_col.setdefault(ch.col, []).append(ch)
            else:
                rest.append(ch)
        merged = []
        for col, leaves in by_col.items():
            if len(leaves) == 1:
                merged.append(leaves[0])
                continue
            merged.append(_SlotMerge(col, node.kind,
                                     [(lf.op, lf.slot) for lf in leaves],
                                     self._engine.ph.columns[col].mu))
        out = merged + rest
        if len(out) == 1:
            return out[0]
        return _SlotNode(node.kind, out)

    def _recipe_cols(self, node, acc):
        if isinstance(node, (_SlotLeaf, _SlotMerge)):
            acc.add(node.col)
            return acc
        for ch in node.children:
            self._recipe_cols(ch, acc)
        return acc

    # ---------------------------------------------------------------- bind

    def encode_literals(self, literals):
        """Scalar per-slot encode (same ``ColumnInfo.encode`` as cold path)."""
        if len(literals) != self.n_slots:
            raise PlanError(
                f"template expects {self.n_slots} literals, got {len(literals)}")
        return [c.encode(v) for c, v in zip(self._columns, literals)]

    def encode_batch(self, rows):
        """Encode a wave's literal vectors in one numpy pass.

        Returns an ``(n_rows, n_slots)`` float array, or ``None`` when this
        shape can't vectorize (categorical slots, string literals) — the
        caller falls back to per-row ``encode_literals``.  Elementwise
        identical to the scalar path: both funnel through ``np.round``.
        """
        if not self.numeric_only or not self.n_slots:
            return None
        try:
            lit = np.asarray(rows, dtype=float)
        except (TypeError, ValueError):
            return None
        if lit.ndim != 2 or lit.shape[1] != self.n_slots:
            return None
        return np.round(lit * self._scales - self._offsets, 6)

    def _bind_tree(self, node, enc):
        if node is None:
            return None
        if isinstance(node, _SlotLeaf):
            return wlib.Leaf(node.col, node.op, enc[node.slot])
        if isinstance(node, _SlotMerge):
            sets = [covlib.cond_to_intervals(op, enc[slot], node.mu)
                    for op, slot in node.parts]
            ivs = (covlib.intersect_intervals(sets) if node.kind == "and"
                   else covlib.union_intervals(sets))
            return wlib.Consolidated(node.col, ivs)
        return wlib.Node(node.kind,
                         [self._bind_tree(ch, enc) for ch in node.children])

    def _assemble(self, enc) -> QueryPlan:
        tree = self._bind_tree(self.recipe, enc)
        plan = QueryPlan(self.func, self.agg_col, tree, self.group_by,
                         self.table, self.exec_col)
        if self.group_by is not None:
            leaves = []
            for cleaf in self.cat_leaves:
                sub = cleaf if tree is None else \
                    wlib.Node("and", [cleaf, tree])
                leaves.append(QueryPlan(self.func, self.agg_col, sub, None,
                                        self.table, self.leaf_exec_col))
            plan.leaf_plans = tuple(leaves)
            plan.group_values = self.group_values
        return plan

    def bind(self, literals) -> QueryPlan:
        """One literal vector -> ``QueryPlan`` (no parse, no raw-tree walk)."""
        return self._assemble(self.encode_literals(literals))

    def bind_batch(self, rows) -> list:
        """Many literal vectors -> plans; encoding vectorized when possible."""
        for row in rows:
            if len(row) != self.n_slots:
                raise PlanError(
                    f"template expects {self.n_slots} literals, got {len(row)}")
        enc = self.encode_batch(rows)
        if enc is None:
            return [self._assemble(self.encode_literals(r)) for r in rows]
        # .tolist() drops back to Python floats so tree_key reprs (and
        # hence canonical/cache keys) match the scalar path exactly.
        return [self._assemble(row) for row in enc.tolist()]


class QueryEngine:
    """Executes the paper's query templates against a PairwiseHist synopsis."""

    def __init__(self, ph: PairwiseHist,
                 corrected_sampling_bounds: bool = False,
                 fastpath=None):
        self.ph = ph
        self.corrected = corrected_sampling_bounds
        # Optional fused CUDA weightings path (repro_torch.core.fastpath).
        self.fastpath = fastpath

    # ------------------------------------------------------------------ API

    def query(self, sql_text: str) -> QueryResult:
        return self.execute_plan(self.plan_sql(sql_text))

    def plan_sql(self, sql_text: str) -> QueryPlan:
        return self.plan_query(sqlmod.parse_sql(sql_text))

    def plan_template(self, parsed: sqlmod.ParsedQuery) -> PlanTemplate:
        """Compile a reusable zero-parse planner for this query's shape.

        The template binds any literal vector of the same fingerprint shape
        (``sql.fingerprint_sql``) into a plan bit-for-bit equal to
        ``plan_query`` on the equivalent parse. Valid for this synopsis
        generation only — encode scales, category tables and consolidation
        grids are baked in at compile (the serving layer epoch-keys its
        template cache accordingly).
        """
        return PlanTemplate(self, parsed)

    def plan_query(self, q: sqlmod.ParsedQuery) -> QueryPlan:
        """Parsed query -> reusable QueryPlan (encode + consolidate).

        GROUP BY queries are additionally expanded into per-category leaf
        plans here (``QueryPlan.leaf_plans``), so downstream executors can
        treat each category as an ordinary single-result plan — in
        particular, batch all leaves through the fused kernel path.
        """
        tree = self._plan(q.where)
        agg_col = None if q.agg_col == "*" else self.ph.col_index(q.agg_col)
        gcol = None if q.group_by is None else self.ph.col_index(q.group_by)
        exec_col = agg_col
        if agg_col is None and tree is not None:   # COUNT(*) with WHERE
            exec_col = min(self._tree_cols(tree, set()))
        plan = QueryPlan(q.func, agg_col, tree, gcol, q.table, exec_col)
        if gcol is not None:
            plan.leaf_plans, plan.group_values = \
                self._expand_group_by(plan, gcol)
        return plan

    def _expand_group_by(self, plan: QueryPlan, gcol: int):
        """GROUP BY plan -> per-category leaf plans (planning-time expansion).

        Leaf trees are built exactly like the sequential ``_group_by`` loop
        (``Node("and", [Leaf(gcol, "=", code), tree])``), so executing a leaf
        plan is bit-for-bit identical to the unbatched per-category path.
        """
        col = self.ph.columns[gcol]
        if col.kind != "categorical":
            raise PlanError(
                f"GROUP BY requires a categorical column, got {col.name!r}")
        exec_col = plan.agg_col
        if exec_col is None:                       # COUNT(*): cheapest column
            # Every leaf tree is {gcol} AND-ed onto the same WHERE tree, so
            # the column set — and hence exec_col — is invariant across
            # categories: compute it once per plan, not once per leaf.
            exec_col = min(self._tree_cols(plan.tree, {gcol}))
        leaves, values = [], []
        for code, value in enumerate(col.categories):
            leaf = wlib.Leaf(gcol, "=", float(code))
            sub = leaf if plan.tree is None else \
                wlib.Node("and", [leaf, plan.tree])
            leaves.append(QueryPlan(plan.func, plan.agg_col, sub, None,
                                    plan.table, exec_col))
            values.append(value)
        return tuple(leaves), tuple(values)

    def execute_plan(self, plan: QueryPlan, weightings=None,
                     leaf_results=None) -> QueryResult:
        """Execute a plan; ``weightings`` optionally supplies a precomputed
        (w, wlo, whi) triple (e.g. from a fused batched kernel launch).

        GROUP BY plans execute their planning-time leaf expansion:
        ``leaf_results`` optionally supplies precomputed per-leaf
        ``QueryResult``s keyed by leaf index (e.g. from a batched serving
        launch or a per-leaf result cache); missing leaves execute here via
        the same ``_single`` path as the sequential oracle.
        """
        t0 = time.perf_counter()
        if plan.leaf_plans:
            result = self._assemble_groups(plan, leaf_results or {})
        elif plan.group_by is not None:    # unexpanded plan: sequential path
            result = self._group_by(plan.func, plan.agg_col, plan.tree,
                                    plan.group_by)
        else:
            result = self._single(plan.func, plan.agg_col, plan.tree,
                                  w_triple=weightings)
        result.latency_s = time.perf_counter() - t0
        return result

    def _assemble_groups(self, plan: QueryPlan, leaf_results) -> QueryResult:
        """Execute any missing GROUP BY leaves, then assemble the groups."""
        full = dict(leaf_results)
        for i, leaf in enumerate(plan.leaf_plans):
            if i not in full:
                full[i] = self._single(leaf.func, leaf.agg_col, leaf.tree)
        return assemble_groups(plan, full)

    def execute(self, func: str, agg_col: int | None, tree,
                group_by: int | None = None) -> QueryResult:
        t0 = time.perf_counter()
        if group_by is not None:
            result = self._group_by(func, agg_col, tree, group_by)
        else:
            result = self._single(func, agg_col, tree)
        result.latency_s = time.perf_counter() - t0
        return result

    # -------------------------------------------------------------- planning

    def _plan(self, raw):
        """RawCond/RawNode -> Leaf/Consolidated/Node with encoded literals."""
        if raw is None:
            return None
        node = self._encode(raw)
        return self._consolidate(node)

    def _encode(self, raw):
        if isinstance(raw, sqlmod.RawCond):
            col = self.ph.col_index(raw.col)
            value = self.ph.columns[col].encode(raw.value)
            return wlib.Leaf(col, raw.op, value)
        return wlib.Node(raw.kind, [self._encode(ch) for ch in raw.children])

    def _consolidate(self, node):
        """Delayed transformation: merge same-column leaves under one AND/OR."""
        if isinstance(node, wlib.Leaf):
            return node
        children = [self._consolidate(ch) for ch in node.children]
        by_col: dict[int, list] = {}
        rest = []
        for ch in children:
            if isinstance(ch, wlib.Leaf):
                by_col.setdefault(ch.col, []).append(ch)
            else:
                rest.append(ch)
        merged = []
        for col, leaves in by_col.items():
            if len(leaves) == 1:
                merged.append(leaves[0])
                continue
            mu = self.ph.columns[col].mu
            sets = [covlib.cond_to_intervals(lf.op, lf.value, mu)
                    for lf in leaves]
            ivs = (covlib.intersect_intervals(sets) if node.kind == "and"
                   else covlib.union_intervals(sets))
            merged.append(wlib.Consolidated(col, ivs))
        out = merged + rest
        if len(out) == 1:
            return out[0]
        return wlib.Node(node.kind, out)

    # ------------------------------------------------------------- execution

    def _tree_cols(self, tree, acc):
        if tree is None:
            return acc
        if isinstance(tree, (wlib.Leaf, wlib.Consolidated)):
            acc.add(tree.col)
            return acc
        for ch in tree.children:
            self._tree_cols(ch, acc)
        return acc

    def _agg_restriction(self, tree, col: int):
        """Necessary interval restriction the predicate imposes on `col`.

        Any matching row's value of `col` must lie in the returned disjoint
        interval set (pre-processed domain). Conditions on other columns are
        unrestrictive. Used to snap MIN/MAX estimates/bounds into the
        feasible region (sound; beyond-paper refinement, DESIGN §7).
        """
        full = [(-np.inf, np.inf)]
        if tree is None:
            return full
        mu = self.ph.columns[col].mu
        if isinstance(tree, wlib.Leaf):
            return covlib.cond_to_intervals(tree.op, tree.value, mu) \
                if tree.col == col else full
        if isinstance(tree, wlib.Consolidated):
            return tree.intervals if tree.col == col else full
        sets = [self._agg_restriction(ch, col) for ch in tree.children]
        if tree.kind == "and":
            return covlib.intersect_intervals(sets)
        return covlib.union_intervals(sets)

    @staticmethod
    def _snap_up(x: float, intervals, mu: float) -> float:
        """Smallest grid value >= x inside the interval set."""
        for lo, hi in intervals:
            cand = max(x, np.ceil((lo + 1e-12) / mu) * mu) if np.isfinite(lo) else x
            if cand <= hi:
                return cand
        return x

    @staticmethod
    def _snap_down(x: float, intervals, mu: float) -> float:
        """Largest grid value <= x inside the interval set."""
        for lo, hi in reversed(intervals):
            cand = min(x, np.floor((hi - 1e-12) / mu) * mu) if np.isfinite(hi) else x
            if cand >= lo:
                return cand
        return x

    def _weightings(self, agg_col, tree):
        if self.fastpath is not None and tree is not None:
            out = self.fastpath(self.ph, agg_col, tree, self.corrected)
            if out is not None:
                return out
        return wlib.weightings(self.ph, agg_col, tree,
                               corrected_sampling_bounds=self.corrected)

    def _single(self, func, agg_col, tree, w_triple=None) -> QueryResult:
        ph = self.ph
        if agg_col is None:  # COUNT(*)
            if tree is None:
                n = float(ph.n_rows)
                return QueryResult(n, n, n)
            agg_col = min(self._tree_cols(tree, set()))
        hist = ph.hists[agg_col]
        col = ph.columns[agg_col]
        w, wlo, whi = (w_triple if w_triple is not None
                       else self._weightings(agg_col, tree))
        rho = ph.rho

        if func == "COUNT":
            est, lo, hi = agg.agg_count(w, wlo, whi, rho)
            return QueryResult(est, lo, hi)

        if col.kind == "categorical" and func not in ("COUNT",):
            raise PlanError(f"{func} over categorical column {col.name!r}")

        # Decode bin value metadata into the raw domain (affine, increasing).
        dec = lambda a: (np.asarray(a, float) + col.offset) / col.scale  # noqa: E731
        c, cm, cp = dec(hist.c), dec(hist.cminus), dec(hist.cplus)
        vmin, vmax = dec(hist.vmin), dec(hist.vmax)
        hist_raw = hist._replace(vmin=vmin, vmax=vmax, c=c, cminus=cm, cplus=cp)

        pred_cols = self._tree_cols(tree, set())
        single_col = pred_cols.issubset({agg_col})

        if func == "SUM":
            est, lo, hi = agg.agg_sum(w, wlo, whi, c, cm, cp, rho)
        elif func == "AVG":
            est, lo, hi = agg.agg_avg(w, wlo, whi, c, cm, cp)
        elif func == "MIN":
            est, lo, hi = agg.agg_min(w, wlo, whi, hist_raw,
                                      ph.params.min_points,
                                      ph.params.s1_max, single_col)
            if not np.isnan(est):
                restrict = self._agg_restriction(tree, agg_col)
                enc = lambda x: x * col.scale - col.offset  # noqa: E731
                dec = lambda x: (x + col.offset) / col.scale  # noqa: E731
                est = dec(self._snap_up(enc(est), restrict, col.mu))
                lo = dec(self._snap_up(enc(lo), restrict, col.mu))
                hi = dec(self._snap_up(enc(hi), restrict, col.mu))
                lo, hi = min(lo, est), max(hi, est)
        elif func == "MAX":
            est, lo, hi = agg.agg_max(w, wlo, whi, hist_raw,
                                      ph.params.min_points,
                                      ph.params.s1_max, single_col)
            if not np.isnan(est):
                restrict = self._agg_restriction(tree, agg_col)
                enc = lambda x: x * col.scale - col.offset  # noqa: E731
                dec = lambda x: (x + col.offset) / col.scale  # noqa: E731
                est = dec(self._snap_down(enc(est), restrict, col.mu))
                lo = dec(self._snap_down(enc(lo), restrict, col.mu))
                hi = dec(self._snap_down(enc(hi), restrict, col.mu))
                lo, hi = min(lo, est), max(hi, est)
        elif func == "MEDIAN":
            est, lo, hi = agg.agg_median(w, wlo, whi, hist_raw)
        elif func == "VAR":
            est, lo, hi = agg.agg_var(w, wlo, whi, c, vmin, vmax)
        else:
            raise PlanError(f"unsupported aggregation {func!r}")
        if np.isnan(est):
            return QueryResult(None, None, None)
        return QueryResult(est, lo, hi)

    def _group_by(self, func, agg_col, tree, gcol) -> QueryResult:
        col = self.ph.columns[gcol]
        if col.kind != "categorical":
            raise PlanError(f"GROUP BY requires a categorical column, got {col.name!r}")
        groups = {}
        for code, value in enumerate(col.categories):
            leaf = wlib.Leaf(gcol, "=", float(code))
            sub = leaf if tree is None else wlib.Node("and", [leaf, tree])
            res = self._single(func, agg_col, sub)
            if res.estimate is not None and res.estimate > 0:
                groups[value] = res.as_tuple()
        return QueryResult(None, None, None, groups=groups)
