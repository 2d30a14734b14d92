"""Nodes expanded over the search's seconds, summed over the window's
proofs (``nodes_expanded`` / ``wall_seconds``, which ends in a read of the
search's counters)."""


def read(run):
    nodes = sum(a["nodes"] for a in run.answers if "nodes" in a)
    wall = sum(a["wall_s"] for a in run.answers if "wall_s" in a)
    return nodes / wall if wall > 0 else None
