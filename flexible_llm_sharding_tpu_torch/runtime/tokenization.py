"""Prompt tokenization for (prefix, suffixes) scoring prompts (the JAX
package's ``runtime/tokenization.py``).

Reference token semantics: pad = eos, right padding; the prefix is tokenized
unpadded (keeps its BOS) and truncated to ``max_token_len``; suffixes are
tokenized as a padded batch with the leading BOS column stripped;
``suffix_eos[s]`` is the index of suffix s's last real token. Lengths are
padded up to bucket multiples, and the suffix count to a multiple of 4, so
that prompts of one bucket form a block; the true lengths travel as values.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def bucket_len(n: int, multiple: int, cap: int | None = None) -> int:
    """Round ``n`` up to a multiple (at least ``multiple``); clamp to ``cap``."""
    b = max(multiple, ((n + multiple - 1) // multiple) * multiple)
    return min(b, cap) if cap is not None else b


@dataclasses.dataclass
class TokenizedPrompt:
    """One prompt padded to bucket shapes.

    prefix_ids int32 [Lp_bucket]; suffix_ids int32 [S_bucket, Ls_bucket];
    prefix_len true prefix length; suffix_eos int32 [S_bucket] (0 for
    padding rows); num_suffixes true suffix count.
    """

    prefix_ids: np.ndarray
    suffix_ids: np.ndarray
    prefix_len: int
    suffix_eos: np.ndarray
    num_suffixes: int

    @property
    def bucket_key(self) -> tuple[int, int, int]:
        return (
            int(self.prefix_ids.shape[0]),
            int(self.suffix_ids.shape[0]),
            int(self.suffix_ids.shape[1]),
        )

    @property
    def tokens_processed(self) -> int:
        """Real tokens one full-model pass runs for this prompt."""
        return self.prefix_len + int((self.suffix_eos[: self.num_suffixes] + 1).sum())


class PromptTokenizer:
    """Wraps a tokenizer with the reference's prefix/suffix conventions."""

    def __init__(self, tokenizer, max_token_len: int = 4096, bucket_multiple: int = 64,
                 suffix_count_multiple: int = 4):
        self.tok = tokenizer
        self.tok.pad_token = self.tok.eos_token
        self.tok.padding_side = "right"
        self.pad_id = self.tok.pad_token_id
        self.max_token_len = max_token_len
        self.bucket_multiple = bucket_multiple
        self.suffix_count_multiple = suffix_count_multiple

    def __call__(self, prefix: str, suffixes: tuple[str, ...]) -> TokenizedPrompt:
        prefix_ids = np.asarray(
            self.tok(prefix, return_attention_mask=False, truncation=True,
                     max_length=self.max_token_len)["input_ids"],
            dtype=np.int32,
        )
        suffix_ids = np.asarray(
            self.tok(list(suffixes), return_attention_mask=False, truncation=True,
                     max_length=self.max_token_len, padding=True)["input_ids"],
            dtype=np.int32,
        )[:, 1:]
        s, ls = suffix_ids.shape
        lp = prefix_ids.shape[0]
        lp_b = bucket_len(lp, self.bucket_multiple, self.max_token_len)
        ls_b = bucket_len(max(ls, 1), self.bucket_multiple, self.max_token_len)
        s_b = bucket_len(s, self.suffix_count_multiple)

        prefix_pad = np.full((lp_b,), self.pad_id, dtype=np.int32)
        prefix_pad[:lp] = prefix_ids
        suffix_pad = np.full((s_b, ls_b), self.pad_id, dtype=np.int32)
        suffix_pad[:s, :ls] = suffix_ids
        eos = np.zeros((s_b,), dtype=np.int32)
        eos[:s] = np.maximum((suffix_ids != self.pad_id).sum(axis=1) - 1, 0)
        return TokenizedPrompt(prefix_pad, suffix_pad, lp, eos, s)


def extend_tokenized(tp: TokenizedPrompt, gen: np.ndarray, pad_id: int,
                     bucket_multiple: int, max_token_len: int) -> TokenizedPrompt:
    """Append already-generated token ids ``gen`` [num_suffixes, n_done]
    directly after each suffix's last real token (ids, never a
    decode/re-encode round trip). Raises ValueError past ``max_token_len``."""
    n_done = int(gen.shape[1])
    if n_done == 0:
        return tp
    eos = tp.suffix_eos
    longest = (int((eos[: tp.num_suffixes] + 1).max()) if tp.num_suffixes else 0) + n_done
    if longest > max_token_len:
        raise ValueError(
            f"extending a suffix to {longest} tokens passes max_token_len={max_token_len}"
        )
    s_b = tp.suffix_ids.shape[0]
    out = np.full((s_b, bucket_len(longest, bucket_multiple, max_token_len)), pad_id, np.int32)
    new_eos = eos.copy()
    for s in range(tp.num_suffixes):
        real = int(eos[s]) + 1
        out[s, :real] = tp.suffix_ids[s, :real]
        out[s, real : real + n_done] = gen[s]
        new_eos[s] = real + n_done - 1
    return TokenizedPrompt(tp.prefix_ids, out, tp.prefix_len, new_eos, tp.num_suffixes)


def make_blocks(tokenized: list[TokenizedPrompt], block_size: int) -> list[list[int]]:
    """Prompt indices grouped into blocks of up to ``block_size`` prompts of
    identical bucket shapes, order kept within a bucket."""
    by_key: dict[tuple[int, int, int], list[int]] = {}
    for i, t in enumerate(tokenized):
        by_key.setdefault(t.bucket_key, []).append(i)
    blocks = []
    for key in sorted(by_key):
        idxs = by_key[key]
        for i in range(0, len(idxs), block_size):
            blocks.append(idxs[i : i + block_size])
    return blocks


__all__ = [
    "PromptTokenizer",
    "TokenizedPrompt",
    "bucket_len",
    "extend_tokenized",
    "make_blocks",
]
