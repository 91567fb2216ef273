"""Quartet hybrid marginal requests (the reference's
quartet_hybrid_request.{hpp,cpp}, gp_dag.cpp QuartetHybridRequestOf; a copy
of libsbn_tpu.gp.quartet)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class QuartetTip:
    node_id: int
    gpcsp_idx: int
    rotated: bool = False  # orientation of the R-PLV for rootward tips


@dataclass(frozen=True)
class QuartetHybridRequest:
    central_gpcsp_idx: int
    rootward_tips: List[QuartetTip] = field(default_factory=list)
    sister_tips: List[QuartetTip] = field(default_factory=list)
    rotated_tips: List[QuartetTip] = field(default_factory=list)
    sorted_tips: List[QuartetTip] = field(default_factory=list)

    def is_fully_formed(self) -> bool:
        return bool(
            self.rootward_tips and self.sister_tips and self.rotated_tips
            and self.sorted_tips
        )


def quartet_hybrid_request_of(dag, parent_id: int, rotated: bool, child_id: int):
    """Port of GPDAG::QuartetHybridRequestOf (gp_dag.cpp:368-411)."""
    rootward_tips = []
    parent_node = dag.nodes[parent_id]
    for rootward_rotated in (False, True):
        for grandparent_id in parent_node.get_rootward(rootward_rotated):
            rootward_tips.append(
                QuartetTip(
                    grandparent_id,
                    dag.gpcsp_index_of_ids(grandparent_id, parent_id),
                    rotated=rootward_rotated,
                )
            )

    sister_tips = []
    is_edge_to_sister_rotated = not rotated
    for sister_id in parent_node.get_leafward(is_edge_to_sister_rotated):
        sister_tips.append(
            QuartetTip(
                sister_id,
                dag.get_gpcsp_index(
                    parent_node.get_bitset(is_edge_to_sister_rotated),
                    dag.nodes[sister_id].subsplit,
                ),
            )
        )

    rotated_tips = []
    sorted_tips = []
    child_node = dag.nodes[child_id]
    for leafward_rotated in (False, True):
        for grandchild_id in child_node.get_leafward(leafward_rotated):
            tip = QuartetTip(
                grandchild_id,
                dag.gpcsp_index_of_ids(child_id, grandchild_id),
            )
            (rotated_tips if leafward_rotated else sorted_tips).append(tip)

    return QuartetHybridRequest(
        dag.gpcsp_index_of_ids(parent_id, child_id),
        rootward_tips, sister_tips, rotated_tips, sorted_tips,
    )
