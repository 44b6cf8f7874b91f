"""The text⇄token codec seam (DESIGN.md §16).

The engines are deliberately integer-token-only, which makes the
tokenizer a *codec seam*: the gateway speaks text on the wire and tokens
to the fleet, through a :class:`Codec` protocol that real tokenizers
(SentencePiece, BPE, ...) can implement without the gateway knowing.
The repo ships a dependency-free byte-level reference codec so the whole
path is exercised end-to-end.

Encoding and decoding are CPU work that must never run on an engine
worker thread (it would eat into the decode cycle) nor on the asyncio
event loop (it would head-of-line block every other connection), so the
gateway funnels them through :class:`CodecPool` — a small thread pool the
HTTP layer reaches via ``loop.run_in_executor``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Codec(Protocol):
    """Invertible text⇄token mapping.

    Contract: ``decode(encode(s)) == s`` for any str ``s`` whose tokens
    all fit the vocabulary, and ``decode`` must tolerate *any* token
    sequence the engine can emit (model samples are not guaranteed to be
    valid encodings — undecodable ids must map to replacement text, never
    raise mid-stream).
    """

    #: ids the codec can produce/consume must be < vocab_limit
    vocab_limit: int

    def encode(self, text: str) -> List[int]: ...

    def decode(self, tokens: Sequence[int]) -> str: ...


class ByteCodec:
    """Reference codec: UTF-8 bytes offset by 1 (id 0 stays the pad id).

    256 byte values + pad = 257 ids, so it fits every config in
    ``repro_torch.configs`` (the smallest reduced vocab is well above that).
    Ids beyond 256 — the model routinely samples them, since it knows
    nothing of the codec — decode to U+FFFD replacement characters, one
    per token, keeping the stream length-preserving and crash-free.
    """

    vocab_limit = 257

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, tokens: Sequence[int]) -> str:
        out = bytearray()
        for t in tokens:
            t = int(t)
            if 1 <= t <= 256:
                out.extend(bytes([t - 1]))
            else:
                out.extend("�".encode("utf-8"))
        return out.decode("utf-8", errors="replace")


_REGISTRY: Dict[str, Callable[[], Codec]] = {"byte": ByteCodec}


def register_codec(name: str, factory: Callable[[], Codec]) -> None:
    """Register a codec factory under ``name`` (the seam real tokenizers
    slot into); re-registering a name replaces the factory."""
    _REGISTRY[name] = factory


def registered_codecs() -> List[str]:
    return sorted(_REGISTRY)


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered: "
                         f"{registered_codecs()}") from None


class CodecPool:
    """Tokenize/detokenize worker pool — codec work off the hot threads.

    Thin and synchronous-API'd on purpose: the HTTP layer submits through
    ``asyncio``'s ``run_in_executor`` so encode/decode latency never
    blocks the event loop, and the fleet's engine threads never see codec
    work at all (they are handed pre-encoded token lists).
    """

    def __init__(self, codec: Codec, workers: int = 2):
        self.codec = codec
        self._ex = ThreadPoolExecutor(max_workers=max(1, workers),
                                      thread_name_prefix="codec")
        self._closed = False

    @property
    def executor(self) -> ThreadPoolExecutor:
        return self._ex

    def encode(self, text: str) -> List[int]:
        return self._ex.submit(self.codec.encode, text).result()

    def decode(self, tokens: Sequence[int]) -> str:
        return self._ex.submit(self.codec.decode, tokens).result()

    async def encode_async(self, loop, text: str) -> List[int]:
        return await loop.run_in_executor(self._ex, self.codec.encode, text)

    async def decode_async(self, loop, tokens: Sequence[int]) -> str:
        return await loop.run_in_executor(
            self._ex, self.codec.decode, list(tokens))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ex.shutdown(wait=True)


__all__ = ["Codec", "ByteCodec", "CodecPool", "get_codec", "register_codec",
           "registered_codecs"]
