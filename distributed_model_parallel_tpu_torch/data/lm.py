"""Language-model data (port of `data/lm.py`): a deterministic synthetic
corpus and a window loader, numpy only.

Tokens follow a fixed random first-order Markov chain, so the best
achievable cross-entropy is the chain's entropy rate (`chain_entropy`)
and a model that learns the transition table shows a clear loss drop
toward it. The RNG consumption order is the reference's, so the same
seed gives the same stream, bit for bit.
"""

from __future__ import annotations

import numpy as np


def _chain_tables(rng: np.random.RandomState, vocab_size: int,
                  branching: int):
    """The chain's (successor-ids, probs) tables, drawn from `rng` —
    the one place the chain's RNG consumption order lives, shared by
    `synthetic_corpus` and `chain_entropy`."""
    live = vocab_size - 1  # ids 1..vocab_size-1
    succ = rng.randint(0, live, size=(live, branching))
    probs = rng.dirichlet(np.ones(branching), size=live)
    return succ, probs


def _walk(succ, probs, walk_rng, num_tokens: int) -> np.ndarray:
    out = np.empty(num_tokens, np.int32)
    state = walk_rng.randint(0, succ.shape[0])
    branching = succ.shape[1]
    for i in range(num_tokens):
        out[i] = state + 1
        state = succ[state, walk_rng.choice(branching, p=probs[state])]
    return out


def synthetic_corpus(
    vocab_size: int = 256,
    num_tokens: int = 1 << 17,
    seed: int = 0,
    branching: int = 4,
    stream_seed: int | None = None,
) -> np.ndarray:
    """A (num_tokens,) int32 token stream from a fixed random Markov
    chain with `branching` successors per token. Id 0 is never emitted
    (it is the padding id downstream). `seed` fixes the chain;
    `stream_seed` (default: `seed`'s own generator) fixes the walk, so a
    validation split is the same chain walked from another seed."""
    rng = np.random.RandomState(seed)
    succ, probs = _chain_tables(rng, vocab_size, branching)
    walk = (
        rng if stream_seed is None else np.random.RandomState(stream_seed)
    )
    return _walk(succ, probs, walk, num_tokens)


def chain_entropy(
    vocab_size: int = 256, seed: int = 0, branching: int = 4,
    num_sample_tokens: int = 1 << 15,
) -> float:
    """Entropy rate (nats/token) of `synthetic_corpus`'s chain: the
    cross-entropy floor of a perfect next-token model. Weighted by the
    empirical state visits of a sample walk (fixed internal seed), since
    the random chain need not be uniform-stationary."""
    rng = np.random.RandomState(seed)
    succ, probs = _chain_tables(rng, vocab_size, branching)
    live = succ.shape[0]
    ent = np.zeros(live)
    for s in range(live):
        p = {}  # merge duplicate successors before the entropy sum
        for j in range(branching):
            p[succ[s, j]] = p.get(succ[s, j], 0.0) + probs[s, j]
        ent[s] = -sum(v * np.log(v) for v in p.values() if v > 0)
    visits = np.bincount(
        _walk(succ, probs, np.random.RandomState(0xC0FFEE),
              num_sample_tokens) - 1,
        minlength=live,
    ).astype(np.float64)
    return float(ent @ (visits / visits.sum()))


class LMLoader:
    """Batches of contiguous (batch, seq_len) windows of a token stream,
    reshuffled per epoch from `seed + epoch`. Yields (ids, ids): the
    second element fills the engines' (inputs, labels) slot; the LM
    engine builds its shifted targets itself (`gpt.lm_targets`)."""

    def __init__(self, corpus: np.ndarray, batch_size: int, seq_len: int,
                 *, shuffle: bool = True, seed: int = 0):
        self.corpus = np.asarray(corpus, np.int32)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.n_windows = len(self.corpus) // seq_len
        if self.n_windows < batch_size:
            raise ValueError(
                f"corpus has {self.n_windows} windows of {seq_len} tokens "
                f"but batch_size is {batch_size}"
            )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return self.n_windows // self.batch_size

    def __iter__(self):
        order = np.arange(self.n_windows)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            ids = np.stack([
                self.corpus[i * self.seq_len:(i + 1) * self.seq_len]
                for i in idx
            ])
            yield ids, ids


__all__ = ["LMLoader", "chain_entropy", "synthetic_corpus"]
