"""Structural cost analysis of compiled (post-SPMD) HLO text.

XLA's built-in cost analysis counts every while-loop body ONCE, so a
scan-over-layers model under-reports FLOPs by ~num_layers x (verified
empirically; see EXPERIMENTS.md).  This parser rebuilds per-device costs from
the HLO text itself:

  * a call graph over computations (while body/condition, fusion calls) with
    *trip-count multipliers* resolved from each while condition's comparison
    constant, so nested scans (layer stack x attention KV blocks x SSD
    chunks) are weighted correctly;
  * FLOPs from `dot` ops (2 * prod(result) * prod(contracting dims));
  * an HBM-traffic model: every top-level op/fusion reads its operands and
    writes its result once (fusion internals excluded -- they live in
    registers/VMEM);
  * collective bytes per opcode (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute), the input to the roofline's
    interconnect term.

All shapes in post-partitioning HLO are per-device, so every figure this
module returns is per-chip.

This is the JAX package's ``repro.launch.hlo_costs`` as it is: it reads
HLO text (for example what that package's dry run compiles) and imports
only the standard library.  The port compiles no XLA, so its own dry run
(``launch.dryrun``) does not call it.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from dataclasses import dataclass, field

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\(?[^=]*?\)?)\s*"
    r"([a-z][a-z0-9\-]*)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->")
_CONST_RE = re.compile(r"%([\w.\-]+)\s*=\s*s32\[\]\s*constant\((\d+)\)")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of a shape string (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


def shape_dims(shape_str: str):
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return None, ()
    dims = tuple(int(d) for d in m.group(2).split(",") if d)
    return m.group(1), dims


@dataclass
class Instr:
    name: str
    shape: str
    opcode: str
    rest: str                       # operand list + attrs (raw)
    operands: list[str] = field(default_factory=list)


@dataclass
class Computation:
    name: str
    instrs: list[Instr] = field(default_factory=list)
    symbols: dict = field(default_factory=dict)    # name -> shape str


def _operand_names(rest: str) -> list[str]:
    """Names inside the op's argument parens (depth-1 split)."""
    depth, out, i = 1, [], 0
    end = len(rest)
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    args = rest[:end]
    return re.findall(r"%([\w.\-]+)", args)


_COMMENT_RE = re.compile(r"/\*.*?\*/")


def parse_module(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for line in text.splitlines():
        # tuple shapes embed /*index=N*/ comments whose '=' breaks parsing
        line = _COMMENT_RE.sub("", line)
        stripped = line.strip()
        if not stripped:
            continue
        if (line.startswith(("%", "ENTRY")) and "{" in line):
            m = _COMP_RE.match(stripped)
            if m:
                cur = Computation(m.group(1))
                comps[cur.name] = cur
                # parameters declared in the header
                hdr = stripped.split("->")[0]
                for pm in re.finditer(r"([\w.\-]+):\s*([a-z0-9]+\[[\d,]*\])",
                                      hdr):
                    cur.symbols[pm.group(1)] = pm.group(2)
                continue
        if cur is None:
            continue
        if stripped.startswith("}"):
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if m:
            name, shape, opcode, rest = m.groups()
            ins = Instr(name, shape.strip(), opcode, rest,
                        _operand_names(rest))
            cur.instrs.append(ins)
            cur.symbols[name] = ins.shape
            # parameters also appear as instructions in nested computations
    return comps


def _attr_ref(rest: str, key: str) -> str | None:
    m = re.search(key + r"=%([\w.\-]+)", rest)
    return m.group(1) if m else None


def _entry_name(comps: dict, text: str) -> str:
    m = re.search(r"ENTRY\s+%?([\w.\-]+)", text)
    if m and m.group(1) in comps:
        return m.group(1)
    # fallback: a computation never referenced by others
    referenced = set()
    for c in comps.values():
        for ins in c.instrs:
            for key in ("calls", "body", "condition", "to_apply"):
                r = _attr_ref(ins.rest, key)
                if r:
                    referenced.add(r)
    for name in comps:
        if name not in referenced:
            return name
    return next(iter(comps))


@dataclass
class HloCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)   # opcode -> bytes
    collective_count: dict = field(default_factory=dict)
    dots: int = 0
    unresolved_while: int = 0
    notes: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collectives),
            "collective_count": dict(self.collective_count),
            "dots": self.dots,
            "unresolved_while": self.unresolved_while,
            "notes": list(self.notes),
        }


def analyze(text: str) -> HloCosts:
    comps = parse_module(text)
    constants = {m.group(1): int(m.group(2))
                 for m in _CONST_RE.finditer(text)}
    entry = _entry_name(comps, text)
    out = HloCosts()

    # -- trip count: prefer XLA's own analysis in backend_config -------------
    _TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')

    def trip_from_config(rest: str) -> int | None:
        m = _TRIP_RE.search(rest)
        return int(m.group(1)) if m else None

    # -- fallback: parse the condition computation's comparison constant -----
    def trip_count(cond_name: str) -> int | None:
        cond = comps.get(cond_name)
        if cond is None:
            return None
        for ins in cond.instrs:
            if ins.opcode in ("compare", "fusion") and (
                    "direction=LT" in ins.rest or ins.opcode == "fusion"):
                for op in ins.operands:
                    if op in constants:
                        return constants[op]
        # constant may live in the condition itself
        for ins in cond.instrs:
            if ins.opcode == "constant":
                m = re.search(r"constant\((\d+)\)", ins.rest)
                if m:
                    return int(m.group(1))
        return None

    # -- propagate execution multipliers over the call graph ----------------
    mult: dict[str, float] = defaultdict(float)
    fusion_only: set[str] = set()       # comps reached only via calls=
    mult[entry] = 1.0
    order = [entry]
    seen = {entry}
    idx = 0
    while idx < len(order):
        cname = order[idx]
        idx += 1
        comp = comps.get(cname)
        if comp is None:
            continue
        m_here = mult[cname]
        for ins in comp.instrs:
            if ins.opcode == "while":
                body = _attr_ref(ins.rest, "body")
                cond = _attr_ref(ins.rest, "condition")
                trips = trip_from_config(ins.rest)
                if trips is None and cond:
                    trips = trip_count(cond)
                if trips is None:
                    trips = 1
                    out.unresolved_while += 1
                for ref, k in ((body, trips), (cond, trips + 1)):
                    if ref:
                        mult[ref] += m_here * k
                        if ref not in seen:
                            seen.add(ref)
                            order.append(ref)
            elif ins.opcode in ("fusion", "call", "custom-call",
                                "conditional", "map", "reduce",
                                "reduce-window", "sort", "scatter",
                                "select-and-scatter"):
                for key in ("calls", "to_apply", "true_computation",
                            "false_computation"):
                    ref = _attr_ref(ins.rest, key)
                    if ref:
                        mult[ref] += m_here
                        fusion_only.add(ref)
                        if ref not in seen:
                            seen.add(ref)
                            order.append(ref)

    body_like = {c for c in seen if c not in fusion_only}

    # -- cost accumulation ---------------------------------------------------
    skip_bytes_ops = {"parameter", "constant", "tuple", "get-tuple-element",
                      "bitcast", "after-all", "partition-id", "replica-id"}
    for cname in seen:
        comp = comps.get(cname)
        if comp is None:
            continue
        m_here = mult[cname]
        if m_here == 0:
            continue
        for ins in comp.instrs:
            # FLOPs: dots anywhere (including inside fusions)
            if ins.opcode == "dot":
                _, rdims = shape_dims(ins.shape)
                lhs_shape = comp.symbols.get(ins.operands[0], "") \
                    if ins.operands else ""
                _, ldims = shape_dims(lhs_shape)
                mm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                               ins.rest)
                contract = 1
                if mm and ldims:
                    for d in mm.group(1).split(","):
                        if d and int(d) < len(ldims):
                            contract *= ldims[int(d)]
                f = 2.0 * contract * math.prod(rdims) if rdims else 0.0
                out.flops += f * m_here
                out.dots += 1
            if cname not in body_like:
                continue
            # HBM traffic: operands + result at kernel granularity
            if ins.opcode not in skip_bytes_ops:
                b = shape_bytes(ins.shape)
                for op in ins.operands:
                    b += shape_bytes(comp.symbols.get(op, ""))
                out.bytes_accessed += b * m_here
            # collectives
            if ins.opcode in COLLECTIVES:
                rb = shape_bytes(ins.shape)
                ob = sum(shape_bytes(comp.symbols.get(op, ""))
                         for op in ins.operands)
                cb = max(rb, ob)
                out.collective_bytes += cb * m_here
                out.collectives[ins.opcode] = \
                    out.collectives.get(ins.opcode, 0.0) + cb * m_here
                out.collective_count[ins.opcode] = \
                    out.collective_count.get(ins.opcode, 0) + 1
    return out
