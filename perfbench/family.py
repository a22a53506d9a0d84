"""A configuration's family: ``families/<family>.py``, found by the
configuration's ``family``, holds all that the benchmark knows of one
family's layer.  A family module defines ``draw`` (its mixer's weights in
the port's layout), ``weight_macs`` and ``sequence_macs`` (its mixer's
work) and ``mixer`` (its plain float32 reference); each hook below it may
define too, and where it does not, the default (the dense layer's, in the
module named) holds:

- ``draw_ffn(cfg, gen, dt, device)``: its FFN's stacked weights, drawn
  after the mixer's from the same generator (``weights.py``: the SwiGLU
  ``mlp_ln`` / ``mlp`` of ``d_ff`` in every layer).
- ``layer_params(dec, li)``: the leaves layer ``li`` takes from the
  stacks ``dec.p["blocks"]`` (``reference/model.py``: entry ``li`` of
  every stacked leaf); a family whose layers differ in kind indexes its
  own stacks.
- ``layer(dec, lp, h)``: the whole layer, (new h, its cache entries)
  (``reference/model.py``: ``h += mixer``, then ``h += ffn``).
- ``ffn(dec, lp, h)``: the FFN's output, added to ``h``
  (``reference/model.py``: the SwiGLU after an RMS norm).
- ``embed_scale(cfg)``, ``logit_scale(cfg)``: factors on the embedding's
  output and on the logits (``reference/model.py``: none).
- ``layer_macs(cfg, li, S)``: layer ``li``'s multiply-adds, (weight
  products for one token, the rest over one sequence of S positions)
  (``flops.py``: the mixer's and the SwiGLU's, the same in every layer).
- ``cache_keys(cfg)``: each entry of the program's prefill cache that is
  compared, and the compared number it falls under
  (``kinds/prefill.py``: ``CACHE_KEYS``).
- ``cache_entry(cfg, cache, key, li)``: where the program's cache holds
  layer ``li``'s entry ``key`` (``kinds/prefill.py``: ``cache[key][li]``).

A new family is a new file here and edits none.
"""
from __future__ import annotations

import importlib


def of(cfg: dict):
    """The family module of configuration ``cfg``."""
    return importlib.import_module(f"families.{cfg['family']}")


def hook(cfg: dict, name: str, default):
    """The family's ``name``, or ``default`` where it defines none."""
    return getattr(of(cfg), name, default)
