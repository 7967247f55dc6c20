"""The one generator of the benchmark's requests, driven by a
configuration's inputs (`inputs/<data>.py`, found by its "data") and a
traffic file's parameters (`traffic/<name>.json`), a closed loop of one
caller:

  "kind": "fit_predict"  request i fits a design of a pool of `members`
                         fixed by `pool_seed` and predicts at its new
                         points: every seed sends the same requests, cycle
                         c of the pool in the order
                         `default_rng([seed, c]).permutation`. Pool entry
                         j is design j of `pool_seed`, with the key
                         fold_in(prng_key(pool_seed), j) split into a fit
                         and a predict key;
  "kind": "predict"      set-up fits one emulator, the same for every
                         seed: design `fit_member` of `pool_seed`, with
                         that request's fit key; query i predicts at m
                         new points uniform on [0, 1]^dim. The m come from
                         a pool of `sizes.count` sizes log-uniform on
                         [low, high] (both ends included) fixed by
                         `pool_seed`, every seed the same sizes: cycle c of
                         the pool runs in the order
                         `default_rng([seed, c]).permutation`. Pool entry
                         j's points come from `default_rng([seed, j])`,
                         its key from fold_in(prng_key(seed), j).

Keys are threefry keys (`reference.threefry`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from harness.spec import load_module
from reference import threefry


@dataclass
class Design:
    x: torch.Tensor
    y: torch.Tensor
    x_new: torch.Tensor


@dataclass
class Request:
    index: int            # position in the run
    member: int           # pool entry
    design: Design
    key_fit: Optional[torch.Tensor]
    key_predict: torch.Tensor
    x_new: torch.Tensor


def design(cfg: dict, seed: int, i: int, device, dtype) -> Design:
    x, y, x_new = load_module("inputs", cfg["data"]).design(cfg, seed, i)
    return Design(*(torch.as_tensor(np.asarray(a), dtype=dtype,
                                    device=device) for a in (x, y, x_new)))


def request_keys(seed: int, i: int, device):
    key = threefry.fold_in(threefry.prng_key(seed), i)
    kf, kp = threefry.split(key, 2)
    return kf.to(device), kp.to(device)


def query_sizes(traffic: dict) -> list:
    s = traffic["sizes"]
    lo, hi, count = s["low"], s["high"], s["count"]
    u = np.random.default_rng(traffic["pool_seed"]).uniform(
        math.log(lo), math.log(hi), size=count)
    sizes = np.clip(np.rint(np.exp(u)).astype(int), lo, hi)
    sizes[0], sizes[-1] = lo, hi
    return [int(m) for m in sizes]


def order(seed: int, members: int, cycle: int) -> np.ndarray:
    return np.random.default_rng([seed, cycle]).permutation(members)


class Stream:
    """The run's requests, in order. A fit request's design is made when
    it is asked for; the query pool is made on `device` in set-up."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype=torch.float32):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.dtype = device, dtype
        self.kind = traffic["kind"]
        if self.kind == "fit_predict":
            self.members = traffic["members"]
        elif self.kind == "predict":
            ps, fm = traffic["pool_seed"], traffic["fit_member"]
            self.fit_design = design(cfg, ps, fm, device, dtype)
            self.fit_key = request_keys(ps, fm, device)[0]
            self.sizes = query_sizes(traffic)
            self.members = len(self.sizes)
            self.points = [torch.as_tensor(
                np.random.default_rng([self.seed, j]).uniform(
                    size=(m, cfg["dim"])), dtype=dtype, device=device)
                for j, m in enumerate(self.sizes)]
            self.keys = [request_keys(self.seed, j, device)[1]
                         for j in range(self.members)]
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self._orders = {}

    def member(self, i: int) -> int:
        c = i // self.members
        if c not in self._orders:
            self._orders = {c: order(self.seed, self.members, c)}
        return int(self._orders[c][i % self.members])

    def request(self, i: int) -> Request:
        j = self.member(i)
        if self.kind == "fit_predict":
            return self.pool_request(i, j)
        return self.query(i, j)

    def pool_request(self, i: int, j: int) -> Request:
        """Request i on fit pool entry j (made when asked for)."""
        ps = self.traffic["pool_seed"]
        d = design(self.cfg, ps, j, self.device, self.dtype)
        kf, kp = request_keys(ps, j, self.device)
        return Request(i, j, d, kf, kp, d.x_new)

    def query(self, i: int, j: int) -> Request:
        """Query i on pool entry j."""
        return Request(i, j, self.fit_design, None, self.keys[j],
                       self.points[j])
