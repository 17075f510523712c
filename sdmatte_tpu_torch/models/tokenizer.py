"""CLIP BPE tokenizer in plain Python with the semantics of transformers'
``CLIPTokenizer``: the port's copy of sdmatte_tpu/models/tokenizer.py.

Captions are padded to max_length=77 and truncated; the vocab/merges files
ship with the SD2.1 config set.  It runs on the host; the ids feed the CLIP
text tower (models/clip.py).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import List, Sequence


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode():
    """GPT-2/CLIP byte<->unicode table (reversible byte encoding)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# HF's pattern uses the regex-module property classes \p{L}/\p{N}; stdlib re
# has no \p, so the exact category ranges are frozen at build time from
# unicodedata (tools/gen_unicode_tables.py -> _unicode_tables.py).  This
# matches the regex module on every codepoint — including combining marks
# (punctuation runs for CLIP, NOT word chars) and non-decimal numerals like
# 'Ⅻ'/'²' (single \p{N} tokens), which a \w-based approximation mis-splits.
from ._unicode_tables import LETTER_CLASS, NUMBER_CLASS  # noqa: E402

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    + f"|[{LETTER_CLASS}]+|[{NUMBER_CLASS}]"
    + f"|[^\\s{LETTER_CLASS}{NUMBER_CLASS}]+",
    re.IGNORECASE,
)


def _split_words(text: str) -> List[str]:
    return _PAT.findall(text)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """vocab.json + merges.txt -> token ids, HF CLIPTokenizer-compatible."""

    def __init__(self, vocab_file: str, merges_file: str, *,
                 model_max_length: int = 77, pad_token: str = "!"):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_file.endswith(".gz") else open
        with opener(merges_file, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # first line is the version header; blank tail lines dropped
        merges = [tuple(m.split()) for m in merges[1:] if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = self.encoder.get("<|endoftext|>", 49407)
        self.unk_token_id = self.eos_token_id  # HF CLIP: unk == endoftext
        self.pad_token = pad_token
        self.pad_token_id = self.encoder.get(pad_token, 0)
        # HF registers the pad token as an added special token, matched
        # atomically before BPE (so a literal "!" in text maps to vocab["!"],
        # not "!</w>") — replicate that with a pre-split.
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in
                           ("<|startoftext|>", "<|endoftext|>", pad_token)) + ")")
        self._cache = {"<|startoftext|>": "<|startoftext|>",
                       "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_pretrained_dir(cls, tok_dir: str) -> "CLIPTokenizer":
        """Load from a diffusers-layout tokenizer dir (vocab.json, merges.txt,
        tokenizer_config.json / special_tokens_map.json for pad token)."""
        pad = "!"
        for meta in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(tok_dir, meta)
            if os.path.exists(p):
                with open(p) as f:
                    d = json.load(f)
                t = d.get("pad_token")
                if isinstance(t, dict):
                    t = t.get("content")
                if t:
                    pad = t
                    break
        return cls(os.path.join(tok_dir, "vocab.json"),
                   os.path.join(tok_dir, "merges.txt"), pad_token=pad)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for seg in self._special_split.split(text):
            if not seg:
                continue
            if seg == self.pad_token:
                ids.append(self.pad_token_id)
                continue
            if seg == "<|startoftext|>":
                ids.append(self.bos_token_id)
                continue
            if seg == "<|endoftext|>":
                ids.append(self.eos_token_id)
                continue
            # Double-unescape matches the SD2.1 training lineage (open_clip's
            # basic_clean, and transformers-with-ftfy which fixes entities to
            # a fixpoint): 'cat &amp;amp; dog' -> 'cat & dog'.  Note that
            # transformers WITHOUT ftfy installed performs no unescape at
            # all — that fork exists upstream, and the checkpoint was trained
            # on the unescaped side of it.
            seg = _whitespace_clean(html.unescape(html.unescape(seg))).lower()
            for tok in _split_words(seg):
                tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder.get(t, self.unk_token_id)
                           for t in self._bpe(tok_bytes).split(" "))
        return ids

    def __call__(self, prompts: Sequence[str] | str):
        """Pad-to-77 + truncate, bos/eos framing; returns list of id lists
        (reference meta_arch.py:225-231 semantics)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        out = []
        for p in prompts:
            ids = self.encode_text(p)
            ids = ids[: self.model_max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            ids = ids + [self.pad_token_id] * (self.model_max_length - len(ids))
            out.append(ids)
        return out
