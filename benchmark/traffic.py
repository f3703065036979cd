"""The one traffic generator: a pool of distinct batches, made on the
device from ``--seed`` in a few calls.

A configuration's ``cloud`` says what one lane's inputs are, and its
``kind`` names the module that makes them (``benchmark/inputs/<kind>.py``);
a traffic mix says how many lanes a batch holds and how many distinct
batches the pool holds.
"""

from __future__ import annotations

import torch

from .cells import module


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """[(positions [B, n, D], normals [B, n, D]) float32] of
    ``traffic["pool_batches"]`` distinct batches of ``traffic["lanes"]``
    lanes."""
    cloud, shape = config["cloud"], tuple(config["grid"])
    B, P = int(traffic["lanes"]), int(traffic["pool_batches"])
    pts, nrm = module("inputs", cloud["kind"]).make(cloud, shape, P * B,
                                                    generator(seed, device), device)
    pts, nrm = pts.float().contiguous(), nrm.float().contiguous()
    return [(pts[i * B:(i + 1) * B], nrm[i * B:(i + 1) * B]) for i in range(P)]
