"""Sequence-to-sequence decoding (counterpart of the reference's
``nn/decode.py``): ``Decoder``, ``BeamSearchDecoder`` and
``dynamic_decode``.

Generation stops on the data, so the loop is an eager Python loop driven
from the host, as the reference's is: each step's beam algebra is a few
torch ops on the device (an fp32 log-softmax, one top-k over the [B, K*V]
scores, the parents' gathers) and the loop reads one bool back a step,
whether every beam has finished.  The back-trace at the end is
``F.gather_tree``.  Decoding runs under ``torch.no_grad()``: no gradient
flows through it (the reference's is inference-only too).

Cell states may be any nesting of tensors, lists, tuples (named ones
too) and dicts; every tensor whose leading dimension is B*K is reordered
by its beam's parent each step (a Transformer decoder's ``Cache`` and
``StaticCache`` lists among them), and any other leaf is passed through.
Token ids, parents and lengths are int64.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]

# the log-probability of a move the search must not take (a finished
# beam's tokens other than the end token; beams 1..K-1 at the start)
_NEG = -1e9


def _map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in it (through lists,
    tuples, named tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map_leaves(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, list):
        return [_map_leaves(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    _map_leaves(lambda t: out.append(t) or t, tree)
    return out


class Decoder:
    """The interface ``dynamic_decode`` drives: ``initialize(inits) ->
    (inputs, states, finished)``, ``step(time, inputs, states) ->
    (outputs, states, next_inputs, finished)`` and ``finalize(outputs,
    final_states, sequence_lengths)``."""

    tracks_own_finished = False

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Beam search over a single-step cell: ``cell(inputs, states) ->
    (outputs, new_states)`` (an ``RNNCellBase`` or any callable of that
    form); ``embedding_fn`` maps the [B*K] token ids to the cell's inputs
    and ``output_fn`` the cell's outputs to [B*K, V] logits (each the
    identity when None)."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        if beam_size < 1:
            raise InvalidArgumentError("beam_size must be >= 1")
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size: int):
        """[B, ...] -> [B*beam_size, ...], each row repeated beam_size
        times in place (for tensors the cell closes over, such as the
        attention memory and its mask)."""
        return torch.repeat_interleave(x.detach(), beam_size, dim=0)

    def initialize(self, initial_cell_states):
        """Tile the cell states to B*K rows; all the start's probability
        mass on beam 0, so the first step picks K distinct tokens."""
        leaves = _leaves(initial_cell_states)
        if not leaves:
            raise InvalidArgumentError(
                "BeamSearchDecoder.initialize needs initial cell states")
        batch, dev = int(leaves[0].shape[0]), leaves[0].device
        k = self.beam_size
        cell_states = _map_leaves(
            lambda t: self.tile_beam_merge_with_batch(t, k),
            initial_cell_states)
        log_probs = torch.full((batch, k), _NEG, device=dev)
        log_probs[:, 0] = 0.0
        init_ids = torch.full((batch, k), self.start_token,
                              dtype=torch.int64, device=dev)
        finished = torch.zeros(batch, k, dtype=torch.bool, device=dev)
        states = {"cell": cell_states, "log_probs": log_probs,
                  "finished": finished,
                  "lengths": torch.zeros(batch, k, dtype=torch.int64,
                                         device=dev)}
        return init_ids, states, finished

    def step(self, time, inputs, states, **kwargs):
        k = self.beam_size
        batch = inputs.shape[0]
        cell_in = inputs.reshape(-1)
        if self.embedding_fn is not None:
            cell_in = self.embedding_fn(cell_in)
        cell_out, next_cell_states = self.cell(cell_in, states["cell"])
        logits = cell_out if self.output_fn is None \
            else self.output_fn(cell_out)
        step_lp = torch.log_softmax(logits.float(), dim=-1)
        vocab = step_lp.shape[-1]
        step_lp = step_lp.reshape(batch, k, vocab)
        # a finished beam may only extend with the end token, at no cost
        finished = states["finished"]
        end_only = torch.full((vocab,), _NEG, device=step_lp.device)
        end_only[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], end_only, step_lp)
        scores = states["log_probs"][..., None] + step_lp
        top_scores, top_idx = torch.topk(scores.reshape(batch, k * vocab), k)
        parent = torch.div(top_idx, vocab, rounding_mode="floor")
        token = top_idx % vocab
        rows = (parent + k * torch.arange(batch, device=parent.device)
                [:, None]).reshape(-1)
        n = batch * k

        def by_parent(t):
            return t.index_select(0, rows) if t.ndim and t.shape[0] == n \
                else t

        next_cell_states = _map_leaves(by_parent, next_cell_states)
        prev_finished = finished.gather(1, parent)
        now_finished = prev_finished | (token == self.end_token)
        lengths = states["lengths"].gather(1, parent) \
            + (~prev_finished).long()
        next_states = {"cell": next_cell_states, "log_probs": top_scores,
                       "finished": now_finished, "lengths": lengths}
        outputs = {"predicted_ids": token, "parent_ids": parent,
                   "scores": top_scores}
        return outputs, next_states, token, now_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """The [T, B, K] sequences back-traced from the last step's beams
        (``F.gather_tree``), and the final states."""
        from .functional.common import gather_tree

        ids = torch.stack([o["predicted_ids"] for o in outputs])
        parents = torch.stack([o["parent_ids"] for o in outputs])
        return gather_tree(ids, parents), final_states


def dynamic_decode(decoder: Decoder, inits=None,
                   max_step_num: Optional[int] = None,
                   output_time_major: bool = False,
                   impute_finished: bool = False, is_test: bool = False,
                   return_length: bool = False, **kwargs) -> Tuple[Any, ...]:
    """Run ``decoder.step`` until every beam has finished (one bool read
    back a step) or ``max_step_num`` steps have run, then ``finalize``.
    Returns ``(ids, final_states)`` -- ids [B, T, K], or [T, B, K] when
    ``output_time_major`` -- and the [B, K] lengths after them when
    ``return_length``.  Without ``max_step_num`` a decoder that never
    finishes raises after 10000 steps."""
    backstop = 10000
    with torch.no_grad():
        inputs, states, finished = decoder.initialize(inits)
        outputs = []
        step = 0
        lengths = torch.zeros(finished.shape, dtype=torch.int64,
                              device=finished.device)
        while max_step_num is None or step < max_step_num:
            alive = ~finished
            out, states, inputs, finished = decoder.step(
                step, inputs, states, **kwargs)
            lengths = lengths + alive.long()
            outputs.append(out)
            step += 1
            if bool(finished.all()):
                break
            if step >= backstop:
                raise InvalidArgumentError(
                    "dynamic_decode ran %d steps without finishing; pass "
                    "max_step_num to bound generation" % backstop)
        if isinstance(states, dict) and "lengths" in states:
            lengths = states["lengths"]  # reordered with the beams
        final_out, final_states = decoder.finalize(outputs, states, lengths)
        if not output_time_major:
            final_out = final_out.movedim(0, 1)
    if return_length:
        return final_out, final_states, lengths
    return final_out, final_states
