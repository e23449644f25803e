"""The one traffic generator: it reads a mix's parameters and gives the
order of the work. It knows two kinds of mix.

  {"kind": "search", "loop": "closed", "clients": 1, "batch": B}
      one caller in a closed loop sends batches of B queries of the
      configuration's query set, each after the previous one's answers
      are on the host: the set in order, batch after batch, and again
      from its start. Every seed sends the same sizes.
  {"kind": "build", "loop": "closed", "clients": 1}
      one caller builds the configuration's index from its rows, build
      after build; the last index built is checked by one search of the
      whole query set at the configuration's search settings, in batches
      of "check_batch" queries.
"""

from __future__ import annotations

import torch

KINDS = ("search", "build")


def check_mix(mix: dict) -> None:
    if mix.get("kind") not in KINDS:
        raise ValueError(f"unknown traffic kind {mix.get('kind')!r}; known: {KINDS}")
    if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError("only a closed loop of one caller is generated")


def query_batches(mix: dict, n_queries: int) -> list:
    """The batches of a search mix (or of a build mix's check), as tensors
    of query positions, in the order the caller sends them; the loop
    repeats the list."""
    check_mix(mix)
    b = int(mix["batch"] if mix["kind"] == "search" else mix["check_batch"])
    if not 0 < b <= n_queries or n_queries % b:
        raise ValueError(f"batch {b} must divide the query set of {n_queries}")
    return list(torch.arange(n_queries).split(b))
