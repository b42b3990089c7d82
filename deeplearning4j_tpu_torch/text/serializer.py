"""Word-vector serialization: text and word2vec C binary formats.

The port of ``deeplearning4j_tpu/text/serializer.py``: the files either
package writes load in the other. Reference analog:
models/embeddings/loader/WordVectorSerializer.java in the reference's
deeplearning4j-nlp (writeWordVectors / loadTxtVectors / readBinaryModel — the loader behind
loadGoogleModel for GoogleNews-vectors-negative300.bin et al.). Loaded
vectors come back either as raw (words, matrix) or as a queryable
StaticWordVectors exposing the WordVectors interface surface
(get_word_vector / similarity / words_nearest).
"""

from __future__ import annotations

import gzip

import numpy as np

from deeplearning4j_tpu_torch.text.word2vec import _host


def save_word_vectors(model, path):
    """Write `<word> <v0> <v1> ...` lines with a `<count> <dim>` header."""
    words = model.vocab.words()
    vecs = _host(model.syn0)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n")
        for i, w in enumerate(words):
            f.write(w + " " + " ".join(f"{v:.6f}" for v in vecs[i]) + "\n")
    return path


def load_word_vectors(path):
    """Returns (words list, matrix [V,D])."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        header = f.readline().split()
        count, dim = int(header[0]), int(header[1])
        words, rows = [], []
        for line in f:
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            rows.append([float(v) for v in parts[1:dim + 1]])
    return words, np.asarray(rows, np.float32)


def save_word2vec_binary(model, path):
    """word2vec C binary format (the GoogleNews interchange format the
    reference reads via readBinaryModel): ASCII `<count> <dim>\\n` header,
    then per word `<word> ` + dim little-endian float32s + `\\n`."""
    words = model.vocab.words()
    vecs = _host(model.syn0).astype(np.float32, copy=False)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n".encode("utf-8"))
        for i, w in enumerate(words):
            f.write(w.encode("utf-8") + b" ")
            f.write(vecs[i].astype("<f4").tobytes())
            f.write(b"\n")
    return path


class _BufReader:
    """Chunked reader: delimiter-scanned word reads + exact-size vector
    reads, so multi-GB models (GoogleNews et al.) load without a Python
    call per byte."""

    def __init__(self, f, chunk=1 << 20):
        self.f = f
        self.chunk = chunk
        self.buf = b""
        self.pos = 0

    def _fill(self):
        data = self.f.read(self.chunk)
        self.buf = self.buf[self.pos:] + data
        self.pos = 0
        return bool(data)

    def read_until(self, delim):
        """Bytes up to (not including) delim; consumes the delimiter."""
        while True:
            idx = self.buf.find(delim, self.pos)
            if idx >= 0:
                out = self.buf[self.pos:idx]
                self.pos = idx + 1
                return out
            if not self._fill():
                raise ValueError("truncated word2vec binary data")

    def read_exact(self, n):
        while len(self.buf) - self.pos < n:
            if not self._fill():
                raise ValueError("truncated vector data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def load_word2vec_binary(path):
    """Read the word2vec C binary format. Returns (words, matrix [V,D]).
    Tolerates both `vec\\n` and bare `vec` record terminators (tools differ,
    the reference's reader skips the byte when present)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        r = _BufReader(f)
        count, dim = (int(x) for x in r.read_until(b"\n").split())
        vec_bytes = dim * 4
        words, rows = [], []
        for _ in range(count):
            w = r.read_until(b" ").lstrip(b"\n")
            buf = r.read_exact(vec_bytes)
            words.append(w.decode("utf-8"))
            rows.append(np.frombuffer(buf, dtype="<f4"))
    return words, np.asarray(rows, np.float32)


class StaticWordVectors:
    """Queryable lookup over loaded vectors (reference: the WordVectors
    interface surface returned by WordVectorSerializer loaders)."""

    def __init__(self, words, matrix):
        self.words = list(words)
        self.matrix = np.asarray(matrix, np.float32)
        self._index = {w: i for i, w in enumerate(self.words)}
        norms = np.linalg.norm(self.matrix, axis=1, keepdims=True)
        self._unit = self.matrix / np.maximum(norms, 1e-12)

    @classmethod
    def load(cls, path, binary=None):
        """Auto-detects text vs binary unless ``binary`` is given: tries the
        text parser first and falls back to binary when the body is not
        parseable text (byte-sniffing heuristics misclassify non-ASCII
        words, which CJK vocabularies make routine)."""
        if binary is True:
            return cls(*load_word2vec_binary(path))
        if binary is False:
            return cls(*load_word_vectors(path))
        try:
            return cls(*load_word_vectors(path))
        except (UnicodeDecodeError, ValueError, IndexError):
            return cls(*load_word2vec_binary(path))

    def has_word(self, word):
        return word in self._index

    def get_word_vector(self, word):
        i = self._index.get(word)
        return None if i is None else self.matrix[i]

    def similarity(self, w1, w2):
        a, b = self._index.get(w1), self._index.get(w2)
        if a is None or b is None:
            return float("nan")
        return float(self._unit[a] @ self._unit[b])

    def words_nearest(self, word, top_n=10):
        i = self._index.get(word)
        if i is None:
            return []
        sims = self._unit @ self._unit[i]
        order = np.argsort(-sims)
        return [(self.words[j], float(sims[j]))
                for j in order if j != i][:top_n]
