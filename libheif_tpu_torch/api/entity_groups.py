"""Entity-group API (ref: api/libheif/heif_entity_groups.h, 2 fns);
counterpart of libheif_tpu/api/entity_groups.py.

grpl EntityToGroup access: altr/ster/pymd and generic groups
(ref: box.h EntityToGroup, heif_entity_groups.h).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class heif_entity_group:
    """(ref: heif_entity_group struct)."""

    entity_group_id: int = 0
    entity_group_type: str = ""
    entities: List[int] = field(default_factory=list)


def heif_context_get_entity_groups(ctx,
                                   type_filter: Optional[str] = None,
                                   item_filter: int = 0
                                   ) -> List[heif_entity_group]:
    """(ref: heif_context_get_entity_groups)."""
    grpl = ctx.file.grpl
    if grpl is None:
        return []
    out = []
    for g in grpl.children:
        if not hasattr(g, "entity_ids"):
            continue
        if type_filter and g.box_type != type_filter:
            continue
        if item_filter and item_filter not in g.entity_ids:
            continue
        out.append(heif_entity_group(entity_group_id=g.group_id,
                                     entity_group_type=g.box_type,
                                     entities=list(g.entity_ids)))
    return out


def heif_entity_groups_release(groups) -> None:
    pass
