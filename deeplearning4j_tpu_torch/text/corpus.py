"""Corpus ingestion SPI: sentence iterators, label-aware document
iterators, and label sources.

Reference analog: the deeplearning4j-nlp ``text/sentenceiterator`` and
``text/documentiterator`` packages —
SentenceIterator.java (next/hasNext/reset/finish + preprocessor slot),
CollectionSentenceIterator, BasicLineIterator/LineSentenceIterator,
FileSentenceIterator, StreamLineIterator, AggregatingSentenceIterator,
MutipleEpochsSentenceIterator (sic), PrefetchingSentenceIterator,
SynchronizedSentenceIterator, labelaware/LabelAware*SentenceIterator,
documentiterator/{LabelledDocument, LabelsSource, BasicLabelAwareIterator,
SimpleLabelAwareIterator, FileLabelAwareIterator,
FilenamesLabelAwareIterator, AsyncLabelAwareIterator}. These are the
front door the reference's Word2Vec/ParagraphVectors builders consume
(SentenceVectors.java's iterate(...) slot); SequenceVectors here accepts
them via ``Word2Vec.fit_iterator`` / ``ParagraphVectors.fit_label_aware``.

Python-idiomatic where it costs nothing: iterators are also plain Python
iterables (``__iter__``), so they drop into any loop; the Java
next/has_next/reset surface is kept verbatim for migration parity.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field


class SentenceIterator:
    """Base contract (reference: SentenceIterator.java): sentences out,
    optional ``pre_processor`` applied in ``next_sentence``."""

    def __init__(self, pre_processor=None):
        self.pre_processor = pre_processor

    # -- Java-parity surface -------------------------------------------
    def next_sentence(self):
        raise NotImplementedError

    def has_next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def finish(self):
        pass

    def get_pre_processor(self):
        return self.pre_processor

    def set_pre_processor(self, pp):
        self.pre_processor = pp

    # -- pythonic surface ----------------------------------------------
    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def _apply(self, s):
        return self.pre_processor(s) if self.pre_processor else s


class CollectionSentenceIterator(SentenceIterator):
    """(reference: CollectionSentenceIterator.java) — any sequence."""

    def __init__(self, sentences, pre_processor=None):
        super().__init__(pre_processor)
        self._sentences = list(sentences)
        self._i = 0

    def next_sentence(self):
        s = self._sentences[self._i]
        self._i += 1
        return self._apply(s)

    def has_next(self):
        return self._i < len(self._sentences)

    def reset(self):
        self._i = 0


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference: BasicLineIterator.java /
    LineSentenceIterator.java)."""

    def __init__(self, path, pre_processor=None, encoding="utf-8"):
        super().__init__(pre_processor)
        self._path = path
        self._encoding = encoding
        self._fh = None
        self._peek = None
        self.reset()

    def _advance(self):
        line = self._fh.readline() if self._fh else ""
        self._peek = line.rstrip("\n") if line else None
        if self._peek is None:
            self.finish()  # close promptly at EOF, not at GC

    def next_sentence(self):
        s = self._peek
        self._advance()
        return self._apply(s)

    def has_next(self):
        return self._peek is not None

    def reset(self):
        self.finish()
        self._fh = open(self._path, encoding=self._encoding)
        self._advance()

    def finish(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


BasicLineIterator = LineSentenceIterator


class StreamLineIterator(SentenceIterator):
    """Lines from an open file-like object (reference:
    StreamLineIterator.java). Not resettable unless the stream is
    seekable."""

    def __init__(self, stream, pre_processor=None):
        super().__init__(pre_processor)
        self._stream = stream
        self._start = stream.tell() if stream.seekable() else None
        self._advance()

    def _advance(self):
        line = self._stream.readline()
        self._peek = line.rstrip("\n") if line else None

    def next_sentence(self):
        s = self._peek
        self._advance()
        return self._apply(s)

    def has_next(self):
        return self._peek is not None

    def reset(self):
        if self._start is None:
            raise ValueError("stream is not seekable; cannot reset")
        self._stream.seek(self._start)
        self._advance()

    def __iter__(self):
        # non-seekable streams iterate from the CURRENT position (the
        # base __iter__ would reset() and raise)
        if self._start is not None:
            self.reset()
        while self.has_next():
            yield self.next_sentence()


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory (recursive, sorted —
    reference: FileSentenceIterator.java)."""

    def __init__(self, root, pre_processor=None, encoding="utf-8"):
        super().__init__(pre_processor)
        self._root = root
        self._encoding = encoding
        self.reset()

    def _files(self):
        out = []
        for dirpath, _, names in sorted(os.walk(self._root)):
            out.extend(os.path.join(dirpath, n) for n in sorted(names))
        return out

    def _gen(self):
        for f in self._files():
            with open(f, encoding=self._encoding) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if line:
                        yield line

    def _advance(self):
        self._peek = next(self._it, None)

    def next_sentence(self):
        s = self._peek
        self._advance()
        return self._apply(s)

    def has_next(self):
        return self._peek is not None

    def reset(self):
        self._it = self._gen()
        self._advance()


class AggregatingSentenceIterator(SentenceIterator):
    """Chains several iterators (reference:
    AggregatingSentenceIterator.java)."""

    def __init__(self, iterators, pre_processor=None):
        super().__init__(pre_processor)
        self._iterators = list(iterators)
        self.reset()

    def next_sentence(self):
        while self._idx < len(self._iterators):
            it = self._iterators[self._idx]
            if it.has_next():
                return self._apply(it.next_sentence())
            self._idx += 1
        raise StopIteration

    def has_next(self):
        return any(it.has_next() for it in self._iterators[self._idx:])

    def reset(self):
        self._idx = 0
        for it in self._iterators:
            it.reset()


class MultipleEpochsSentenceIterator(SentenceIterator):
    """Replays the underlying iterator n_epochs times (reference:
    MutipleEpochsSentenceIterator.java — typo theirs)."""

    def __init__(self, iterator, n_epochs):
        super().__init__(None)
        self._under = iterator
        self._epochs = n_epochs
        self.reset()

    def next_sentence(self):
        if not self.has_next():
            raise StopIteration("all epochs consumed")
        if not self._under.has_next():
            self._epoch += 1
            self._under.reset()
        return self._under.next_sentence()

    def has_next(self):
        if self._empty:
            return False
        return self._under.has_next() or self._epoch + 1 < self._epochs

    def reset(self):
        self._epoch = 0
        self._under.reset()
        self._empty = not self._under.has_next()


class _PrefetchPump:
    """Shared background-prefetch machinery (bounded queue + reader
    thread + stop-flag shutdown) for PrefetchingSentenceIterator and
    AsyncLabelAwareIterator — the FancyBlockingQueue role in Python."""

    _DONE = object()

    def __init__(self, produce_next, has_more, buffer_size):
        self._produce = produce_next
        self._more = has_more
        self._size = buffer_size
        self._thread = None
        self._stop = None
        self._error = None
        self.peek = None

    def _run(self, q, stop):
        try:
            while not stop.is_set() and self._more():
                item = self._produce()
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # rethrown on the consumer side —
            self._error = e         # a dead producer must NOT read as a
        finally:                    # clean end-of-corpus
            if stop.is_set():
                # shutdown path: nothing reads past the stop flag
                try:
                    q.put_nowait(self._DONE)
                except queue.Full:
                    pass
            else:
                # normal completion: the consumer IS reading — a blocking
                # put guarantees _DONE arrives even through a full queue
                q.put(self._DONE)

    def advance(self):
        nxt = self._queue.get()
        if nxt is self._DONE and self._error is not None:
            err, self._error = self._error, None
            self.peek = None
            raise err
        self.peek = None if nxt is self._DONE else nxt

    def start(self):
        self.stop()
        self._queue = queue.Queue(maxsize=self._size)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._queue, self._stop), daemon=True)
        self._thread.start()
        self.advance()

    def stop(self):
        """O(buffer) shutdown: signal the pump, unblock it, join."""
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:  # unblock a pump stuck on a full queue
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
        self._thread = None
        self.peek = None


class PrefetchingSentenceIterator(SentenceIterator):
    """Background-thread prefetch buffer (reference:
    PrefetchingSentenceIterator.java — its dedicated reader thread +
    bounded queue)."""

    def __init__(self, iterator, buffer_size=128):
        super().__init__(None)
        self._under = iterator
        self._pump = _PrefetchPump(iterator.next_sentence,
                                   iterator.has_next, buffer_size)
        self.reset()

    def next_sentence(self):
        s = self._pump.peek
        self._pump.advance()
        return s

    def has_next(self):
        return self._pump.peek is not None

    def reset(self):
        self._pump.stop()
        self._under.reset()
        self._pump.start()

    def finish(self):
        self._pump.stop()


class SynchronizedSentenceIterator(SentenceIterator):
    """Lock-guarded wrapper for shared consumption (reference:
    SynchronizedSentenceIterator.java). The has_next()/next_sentence()
    PAIR is not atomic across consumers (same as the reference's
    per-method synchronization); multi-consumer code should use
    ``next_or_none()``, which checks and consumes under ONE lock."""

    def __init__(self, iterator):
        super().__init__(None)
        self._under = iterator
        self._lock = threading.Lock()

    def next_or_none(self):
        """Atomic check-and-consume: the multi-consumer primitive."""
        with self._lock:
            if not self._under.has_next():
                return None
            return self._under.next_sentence()

    def next_sentence(self):
        s = self.next_or_none()
        if s is None:
            raise StopIteration("iterator exhausted")
        return s

    def has_next(self):
        with self._lock:
            return self._under.has_next()

    def reset(self):
        with self._lock:
            self._under.reset()

    def __iter__(self):
        self.reset()
        while True:
            s = self.next_or_none()
            if s is None:
                return
            yield s


# ---------------------------------------------------------------------------
# Label-aware tier (reference: sentenceiterator/labelaware + documentiterator)
# ---------------------------------------------------------------------------


@dataclass
class LabelledDocument:
    """(reference: documentiterator/LabelledDocument.java)"""

    content: str
    labels: list = field(default_factory=list)

    @property
    def label(self):
        return self.labels[0] if self.labels else None


class LabelsSource:
    """Label generator/registry (reference: LabelsSource.java): either a
    template ("SENT_" -> SENT_0, SENT_1, ... or "DOC_%d_x" with the
    counter spliced at %d) or a predefined list."""

    def __init__(self, template_or_labels="SENT_"):
        if isinstance(template_or_labels, str):
            self._template = template_or_labels
            self._given = None
        else:
            self._template = None
            self._given = list(template_or_labels)
        self._counter = 0
        self._seen = []

    def next_label(self):
        if self._given is not None:
            if self._counter >= len(self._given):
                raise ValueError(
                    f"LabelsSource has {len(self._given)} predefined labels "
                    f"but a {self._counter + 1}th document arrived — the "
                    "label list must match the corpus size")
            label = self._given[self._counter]
        elif "%d" in self._template:
            label = self._template.replace("%d", str(self._counter))
        else:
            label = f"{self._template}{self._counter}"
        self._counter += 1
        if self._given is None:
            self._seen.append(label)
        return label

    def get_labels(self):
        return list(self._given if self._given is not None else self._seen)

    def index_of(self, label):
        return self.get_labels().index(label)

    def size(self):
        return len(self.get_labels())

    def reset(self):
        self._counter = 0
        if self._given is None:
            self._seen = []


class LabelAwareIterator:
    """Base document-iterator contract (reference: LabelAwareIterator.java).
    Yields LabelledDocument; also a plain Python iterable."""

    def next_document(self):
        raise NotImplementedError

    def has_next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def get_label_source(self):
        return getattr(self, "labels_source", None)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wraps an iterable of LabelledDocument (reference:
    SimpleLabelAwareIterator.java)."""

    def __init__(self, documents):
        self._docs = list(documents)
        self._i = 0

    def next_document(self):
        d = self._docs[self._i]
        self._i += 1
        return d

    def has_next(self):
        return self._i < len(self._docs)

    def reset(self):
        self._i = 0


class BasicLabelAwareIterator(LabelAwareIterator):
    """SentenceIterator + LabelsSource -> labelled documents (reference:
    BasicLabelAwareIterator.java — the ParagraphVectors default when fed
    plain sentences)."""

    def __init__(self, sentence_iterator, labels_source=None):
        self._under = sentence_iterator
        self.labels_source = labels_source or LabelsSource()

    def next_document(self):
        return LabelledDocument(self._under.next_sentence(),
                                [self.labels_source.next_label()])

    def has_next(self):
        return self._under.has_next()

    def reset(self):
        self._under.reset()
        self.labels_source.reset()


class FileLabelAwareIterator(LabelAwareIterator):
    """Directory-per-label corpus (reference: FileLabelAwareIterator.java):
    root/<label>/<file> — each file is one document labelled by its
    parent directory."""

    def __init__(self, root, encoding="utf-8"):
        self._root = root
        self._encoding = encoding
        self.labels_source = LabelsSource(sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))))
        self.reset()

    def _entries(self):
        for label in sorted(os.listdir(self._root)):
            full = os.path.join(self._root, label)
            if not os.path.isdir(full):
                continue
            for name in sorted(os.listdir(full)):
                yield label, os.path.join(full, name)

    def next_document(self):
        label, path = self._peek
        self._peek = next(self._it, None)
        with open(path, encoding=self._encoding) as fh:
            return LabelledDocument(fh.read().strip(), [label])

    def has_next(self):
        return self._peek is not None

    def reset(self):
        self._it = self._entries()
        self._peek = next(self._it, None)


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """One document per file, labelled by its filename (reference:
    FilenamesLabelAwareIterator.java)."""

    def __init__(self, root, strip_extension=True, encoding="utf-8"):
        self._root = root
        self._strip = strip_extension
        self._encoding = encoding
        self.reset()

    def _files(self):
        return sorted(n for n in os.listdir(self._root)
                      if os.path.isfile(os.path.join(self._root, n)))

    def next_document(self):
        name = self._names[self._i]
        self._i += 1
        label = os.path.splitext(name)[0] if self._strip else name
        with open(os.path.join(self._root, name),
                  encoding=self._encoding) as fh:
            return LabelledDocument(fh.read().strip(), [label])

    def has_next(self):
        return self._i < len(self._names)

    def reset(self):
        self._names = self._files()
        self._i = 0


class AsyncLabelAwareIterator(LabelAwareIterator):
    """Background-thread prefetch over any LabelAwareIterator (reference:
    AsyncLabelAwareIterator.java). Shares the _PrefetchPump machinery."""

    def __init__(self, iterator, buffer_size=64):
        self._under = iterator
        self.labels_source = iterator.get_label_source()
        self._pump = _PrefetchPump(iterator.next_document,
                                   iterator.has_next, buffer_size)
        self.reset()

    def next_document(self):
        d = self._pump.peek
        self._pump.advance()
        return d

    def has_next(self):
        return self._pump.peek is not None

    def reset(self):
        self._pump.stop()
        self._under.reset()
        self._pump.start()
