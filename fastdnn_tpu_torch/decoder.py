"""Minimal token-passing beam-search decoder driving lazy acoustic scoring:
the counterpart of fastdnn_tpu/decoder.py, in numpy (importing the JAX
package's module would import JAX).

A Viterbi beam search over a word lexicon of left-to-right senone chains,
where the active senone set of each frame comes from the live beam, which
is what the lazy (masked) API exists for.  The engine integration points:

  * `decode_lazy`    frame-synchronous decoding through `LazyContext`: each
                     frame's mask is the union of senones the surviving
                     tokens can consume next.
  * `decode_dense`   the same search over full posteriors (`Scorer.score`),
                     the oracle `decode_lazy` must agree with.
  * `decode_rescore` two passes: record the mask trajectory, then hand the
                     whole [frames, senones] mask matrix to
                     `Scorer.score_masked` in one call.

The decoder is small on purpose (unigram word loop, no LM scores, no
lattice): it exercises the masked API with real beam dynamics.

Lazy and dense decoding agree: under the default "reference" semantics
inactive senones add exp(0) to the softmax denominator, so active
posteriors shrink by one factor per frame, shared by every token; within a
frame the order of active senones is kept, so Viterbi comparisons do not
change and the decoded words match dense decoding whenever the beam holds.
Under "active_only" the shift is the renormalization constant instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Lexicon", "BeamDecoder", "DecodeResult", "random_lexicon"]

LOG_FLOOR = 1e-10  # posteriors at/below this score as log(LOG_FLOOR)


@dataclasses.dataclass(frozen=True)
class Lexicon:
    """Words as left-to-right senone chains (a synthetic HMM topology:
    one senone per state, self-loop + advance arcs)."""

    words: Tuple[Tuple[int, ...], ...]

    @property
    def start_senones(self) -> np.ndarray:
        return np.array(sorted({w[0] for w in self.words}), np.int64)

    def validate(self, senone_count: int) -> None:
        for w in self.words:
            if not w or min(w) < 0 or max(w) >= senone_count:
                raise ValueError(f"word {w} out of senone range [0, {senone_count})")


def random_lexicon(
    rng: np.random.Generator,
    n_words: int,
    senone_count: int,
    min_states: int = 3,
    max_states: int = 6,
) -> Lexicon:
    """Random word chains (distinct senones within a word)."""
    words = []
    for _ in range(n_words):
        n = int(rng.integers(min_states, max_states + 1))
        words.append(tuple(int(s) for s in rng.choice(senone_count, n, replace=False)))
    return Lexicon(tuple(words))


@dataclasses.dataclass
class DecodeResult:
    words: List[int]  # best path's word ids, in order
    score: float  # total log path score
    masks: np.ndarray  # [frames, senones] uint8 — the active sets actually used
    avg_density: float
    avg_churn: float  # mean fraction of senones flipping between frames


class BeamDecoder:
    """Token-passing Viterbi beam search over a Lexicon.

    A token is (word_id, state_index) with a score and word history; each
    frame every token tries its self-loop and advance arcs, word-final
    tokens may also enter any word's first state (unigram loop, applied to
    the top `word_exit_beam` word-final tokens so start fan-out stays
    bounded, like a pruned real decoder).
    """

    def __init__(
        self,
        lexicon: Lexicon,
        senone_count: int,
        *,
        beam_width: int = 64,
        word_exit_beam: int = 8,
    ):
        lexicon.validate(senone_count)
        self.lexicon = lexicon
        self.senone_count = senone_count
        self.beam_width = beam_width
        self.word_exit_beam = word_exit_beam

    # -- beam mechanics -------------------------------------------------------

    def _initial_tokens(self) -> Dict[Tuple[int, int], Tuple[float, Tuple[int, ...]]]:
        return {(w, 0): (0.0, (w,)) for w in range(len(self.lexicon.words))}

    def _successors(self, tokens):
        """(token, arcs) pairs: each arc is (word, state) the token can
        consume next frame.  Word-final tokens of the exit beam also open
        every word's first state."""
        words = self.lexicon.words
        arcs = []
        finals = sorted(
            (
                (score, key, hist)
                for key, (score, hist) in tokens.items()
                if key[1] == len(words[key[0]]) - 1
            ),
            reverse=True,
        )[: self.word_exit_beam]
        exit_set = {key for _, key, _ in finals}
        for (w, s), (score, hist) in tokens.items():
            arcs.append(((w, s), (w, s), score, hist))  # self-loop
            if s + 1 < len(words[w]):
                arcs.append(((w, s), (w, s + 1), score, hist))  # advance
            elif (w, s) in exit_set:
                for nw in range(len(words)):  # word loop
                    arcs.append(((w, s), (nw, 0), score, hist + (nw,)))
        return arcs

    def active_mask(self, tokens, arcs=None) -> np.ndarray:
        """The senones next frame's arcs consume — THE lazy mask.

        Pass `arcs` (a `_successors(tokens)` result) when the caller also
        steps the beam this frame, so the expansion is computed once."""
        mask = np.zeros(self.senone_count, np.uint8)
        for _, (w, s), _, _ in arcs if arcs is not None else self._successors(tokens):
            mask[self.lexicon.words[w][s]] = 1
        return mask

    def _step(self, tokens, log_post: np.ndarray, arcs=None):
        """Advance the beam by one frame of (already masked) log posteriors."""
        best: Dict[Tuple[int, int], Tuple[float, Tuple[int, ...]]] = {}
        for _, (w, s), score, hist in arcs if arcs is not None else self._successors(tokens):
            ns = score + log_post[self.lexicon.words[w][s]]
            cur = best.get((w, s))
            if cur is None or ns > cur[0]:
                best[(w, s)] = (ns, hist)
        pruned = sorted(best.items(), key=lambda kv: -kv[1][0])[: self.beam_width]
        return dict(pruned)

    @staticmethod
    def _log(p: np.ndarray) -> np.ndarray:
        return np.log(np.maximum(p, LOG_FLOOR))

    @staticmethod
    def _result(tokens, masks: List[np.ndarray]) -> DecodeResult:
        (w, s), (score, hist) = max(tokens.items(), key=lambda kv: kv[1][0])
        m = np.stack(masks)
        density = float(m.mean())
        churn = (
            float(np.abs(np.diff(m.astype(np.int8), axis=0)).mean()) if len(m) > 1 else 0.0
        )
        return DecodeResult(list(hist), float(score), m, density, churn)

    # -- engine-facing decode loops --------------------------------------------

    def decode_dense(self, scorer, frames: np.ndarray) -> DecodeResult:
        """Oracle: full posteriors for every frame (Scorer.score), masks
        recorded for comparison but not used for scoring."""
        post = scorer.score(frames)
        tokens = self._initial_tokens()
        masks = []
        for t in range(frames.shape[0]):
            arcs = self._successors(tokens)
            masks.append(self.active_mask(tokens, arcs))
            tokens = self._step(tokens, self._log(post[t]), arcs)
        return self._result(tokens, masks)

    def decode_lazy(self, scorer, frames: np.ndarray) -> DecodeResult:
        """Frame-synchronous lazy decoding through LazyContext: hidden
        layers run ONCE for the whole utterance, then each frame scores
        only the senones the live beam can consume."""
        ctx = scorer.new_lazy_context(frames.shape[0])
        ctx.calculate_until_output(frames)
        tokens = self._initial_tokens()
        masks = []
        for _ in range(frames.shape[0]):
            arcs = self._successors(tokens)
            mask = self.active_mask(tokens, arcs)
            masks.append(mask)
            post = ctx.calculate_for_output_nodes(mask)
            tokens = self._step(tokens, self._log(post), arcs)
        return self._result(tokens, masks)

    def decode_rescore(
        self, scorer, frames: np.ndarray, masks: Optional[np.ndarray] = None
    ) -> DecodeResult:
        """Two-pass: score the recorded mask trajectory in ONE device call
        (Scorer.score_masked), then search over the masked posteriors."""
        if masks is None:
            masks = self.decode_lazy(scorer, frames).masks
        post = scorer.score_masked(frames, masks)
        tokens = self._initial_tokens()
        for t in range(frames.shape[0]):
            tokens = self._step(tokens, self._log(post[t]))
        return self._result(tokens, list(masks))
