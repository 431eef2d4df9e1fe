"""Tokenizers for the serving engine.

Two implementations behind one protocol:

- ByteTokenizer — self-contained UTF-8 byte-level tokenizer (PAD/BOS/EOS +
  256 byte ids). The engine's default: needs no external vocab files, so the
  whole stack runs hermetically (the same zero-external-dependency discipline
  as the reference's mock backend, SURVEY.md §4).
- HFTokenizer — adapter over a local `transformers` tokenizer directory for
  serving real checkpoints (Llama-3 / Mixtral / Gemma vocab files). Loaded
  lazily; never fetches from the network.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes with 3 specials. Vocab: 0=PAD, 1=BOS, 2=EOS, 3+b=byte b.

    ``eos_id`` is -1 — the "no EOS" sentinel (models/generate.py
    convention): the engine's stop condition ``token == eos_id`` then
    never fires. Id 2 stays RESERVED in the vocab layout (a trained
    byte-level checkpoint that wants an EOS can claim it and serve
    through HFTokenizer-style config), but this hermetic tokenizer only
    ever fronts random-init or synthetic-corpus models, which emit any
    low id with ~uniform probability — nothing ever TRAINS id 2 to mean
    "stop", so honoring it made every exact-budget test and every bench
    stream length a per-prompt coin flip (root cause of the seed-carried
    test_int8_kv_engine_serves failure: the fp32 engine and the
    non-paged golden forward produce the IDENTICAL 8-token stream ending
    in id 2 — the early stop was faithful decoding of a meaningless
    "EOS", not an int8-KV defect)."""

    pad_id = 0
    bos_id = 1
    eos_id = -1          # no EOS: id 2 is reserved but never honored
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + [3 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # Ids outside the byte range (specials below, or a model vocab larger
        # than 259 sampling unmapped ids) are skipped rather than crashing.
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")

    def decode_incremental(self, ids: Sequence[int], state: bytes = b"") -> tuple[str, bytes]:
        """Streaming decode: returns (complete text, undecoded byte tail).

        UTF-8 sequences can split across token boundaries; the tail carries
        incomplete sequences into the next call so streamed chunks never
        contain replacement characters mid-character.
        """
        data = state + bytes(i - 3 for i in ids if 3 <= i < 259)
        # Find the longest decodable prefix (max 3 trailing continuation bytes).
        for cut in range(len(data), max(len(data) - 4, -1), -1):
            try:
                return data[:cut].decode("utf-8"), data[cut:]
            except UnicodeDecodeError:
                continue
        return "", data


class HFTokenizer:
    """Local HuggingFace tokenizer adapter (no network access)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # lazy; heavy import

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id or 0
        self.eos_id = self._tok.eos_token_id or 0
        self.pad_id = self._tok.pad_token_id or self.eos_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


class IncrementalDetokenizer:
    """Bounded-window incremental detokenization for context-dependent
    tokenizers (BPE / sentencepiece, where decode(prefix + t) is not
    decode(prefix) + decode(t)).

    The naive streaming approach re-decodes the full prefix per token —
    O(n²) host work over a stream. This keeps the standard two-offset
    window (the vLLM detokenizer recurrence): `prefix_offset` marks ids
    whose text is committed, `read_offset` marks ids represented in
    emitted text; each push decodes only ids[prefix_offset:], a handful
    of tokens in steady state. A delta is emitted only when the window's
    text GROWS and doesn't end in U+FFFD (an incomplete byte-fallback
    sequence must finish before its text is released, so streamed chunks
    never contain replacement characters mid-character).

    ''.join of pushes equals decode(all ids) up to any trailing
    incomplete sequence, which `flush()` reports."""

    def __init__(self, tok: Tokenizer):
        self._tok = tok
        self._ids: list[int] = []
        self._prefix_off = 0
        self._read_off = 0

    _WINDOW_CAP = 64   # force-commit bound on uncommitted ids

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        prefix = self._tok.decode(self._ids[self._prefix_off:self._read_off])
        full = self._tok.decode(self._ids[self._prefix_off:])
        if len(full) > len(prefix) and not full.endswith("�"):
            self._prefix_off = self._read_off
            self._read_off = len(self._ids)
            return full[len(prefix):]
        if len(self._ids) - self._prefix_off > self._WINDOW_CAP:
            # Degenerate run (e.g. skipped specials or invalid byte
            # fallback) whose text never grows: force-commit so the
            # window — and the per-push re-decode — stays bounded, even
            # at the cost of releasing a trailing U+FFFD.
            delta = full[len(prefix):] if len(full) > len(prefix) else ""
            self._prefix_off = self._read_off = len(self._ids)
            return delta
        return ""

    def flush(self) -> str:
        """Text still held back (e.g. a trailing incomplete sequence)."""
        prefix = self._tok.decode(self._ids[self._prefix_off:self._read_off])
        full = self._tok.decode(self._ids[self._prefix_off:])
        self._prefix_off = self._read_off = len(self._ids)
        return full[len(prefix):] if len(full) > len(prefix) else ""


def load_tokenizer(spec: str) -> Tokenizer:
    """'byte' → ByteTokenizer; anything else is a local HF tokenizer path."""
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
