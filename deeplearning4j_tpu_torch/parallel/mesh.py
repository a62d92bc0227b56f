"""The mesh vocabulary (the part of ``deeplearning4j_tpu/parallel/mesh.py``
that ``MultiSliceTrainer`` uses): the axis constants and
:class:`MeshSpec`, the parse target of every layout flag (``"dp2"``,
``"dp2xtp2xpp2"``).

Axis conventions, the JAX package's:

- ``data``   — batch sharding (DP); gradients are summed over this axis;
- ``model``  — tensor-parallel sharding of weight matrices (TP);
- ``seq``    — sequence/context parallelism (ring attention);
- ``pipe``   — pipeline stages;
- ``expert`` — expert parallelism (MoE).

Not ported yet: ``MeshLayout``, ``resolve_layout``, ``make_mesh``, the
tensor-parallel rule tables and the placement helpers.  They come with
the dense layouts over ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import re

AXIS_PIPE = "pipe"
AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"

# every mesh's axes, in layout order (outermost → innermost)
MESH_AXES = (AXIS_PIPE, AXIS_DATA, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)

# the axes that shard the batch
DATA_AXES = (AXIS_DATA,)

# layout token → axis name for MeshSpec.parse ("dp2xtp2xpp2")
_LAYOUT_TOKENS = {
    "dp": AXIS_DATA, "tp": AXIS_MODEL, "pp": AXIS_PIPE, "sp": AXIS_SEQ, "ep": AXIS_EXPERT,
    AXIS_DATA: AXIS_DATA, AXIS_MODEL: AXIS_MODEL, AXIS_PIPE: AXIS_PIPE,
    AXIS_SEQ: AXIS_SEQ, AXIS_EXPERT: AXIS_EXPERT,
}

_TOKEN_RE = re.compile(r"([a-z]+)(\d+)")


@dataclasses.dataclass
class MeshSpec:
    """Axis sizes of a mesh: the parse target of every layout flag."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def total(self) -> int:
        return self.data * self.model * self.seq * self.pipe * self.expert

    def sizes(self) -> dict[str, int]:
        """Axis name → size, in :data:`MESH_AXES` vocabulary."""
        return {AXIS_PIPE: self.pipe, AXIS_DATA: self.data, AXIS_SEQ: self.seq,
                AXIS_EXPERT: self.expert, AXIS_MODEL: self.model}

    @classmethod
    def parse(cls, layout: str) -> "MeshSpec":
        """``"dp2xtp2xpp2"`` (or ``"data2_model2"``) → MeshSpec.  Tokens:
        dp=data, tp=model, pp=pipe, sp=seq, ep=expert; sizes are positive
        ints; the separators ``x``, ``_``, ``,`` and ``*`` are equivalent."""
        spec = cls()
        seen: set[str] = set()
        text = layout.strip().lower()
        if not text:
            raise ValueError("empty layout string")
        for part in re.split(r"[x_,*]+", text):
            if not part:
                continue
            m = _TOKEN_RE.fullmatch(part)
            if not m or m.group(1) not in _LAYOUT_TOKENS:
                raise ValueError(
                    f"unparseable layout token {part!r} in {layout!r} (tokens: dp/tp/pp/sp/ep "
                    f"or data/model/pipe/seq/expert + a positive size, e.g. 'dp2xtp2')")
            axis = _LAYOUT_TOKENS[m.group(1)]
            if axis in seen:
                raise ValueError(f"axis {axis!r} given twice in {layout!r}")
            seen.add(axis)
            size = int(m.group(2))
            if size < 1:
                raise ValueError(f"axis size must be >= 1 in {layout!r}")
            setattr(spec, axis, size)
        if not seen:
            raise ValueError(f"layout {layout!r} names no axis (tokens: dp/tp/pp/sp/ep + a "
                             f"positive size)")
        return spec

    def describe(self) -> str:
        """The stable short form (``"dp2xtp2xpp2"``; ``"single"`` when
        trivial): the layout's label on metrics and cache keys."""
        parts = [f"{token}{size}" for token, size in
                 (("dp", self.data), ("tp", self.model), ("pp", self.pipe), ("sp", self.seq),
                  ("ep", self.expert)) if size > 1]
        return "x".join(parts) if parts else "single"
