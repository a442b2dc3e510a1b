"""Host-side audio dataset and prefetching data loader, the port's copy of
the JAX package's `data/dataset.py` (which uses numpy, scipy and Python's
`random` and no JAX): a recursive audio glob, mono downmix, resampling to
the highest target rate (`scipy.signal.resample_poly`), a seeded random
crop or right pad to max_length, then one output per target rate, each
curtailed to its own multiple; collation that pads to the longest (or
curtails to the shortest) and passes tuples and strings through. From the
same folder and seeds it gives the same batches as the JAX package's.

The loader is the JAX package's: worker threads, batches released in
ticket order, a seeded shuffle. Batches are numpy arrays; the trainer moves
each to the card once. WAV files decode in-process, FLAC and the FFmpeg
formats through the native decoders (`utils/audio_io.py`).
"""
from __future__ import annotations

import math
import random
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.audio_io import load_audio

__all__ = ["SoundDataset", "get_dataloader", "collate_one_or_multiple_tensors"]


def _cast_tuple(v, n=1):
    return v if isinstance(v, tuple) else (v,) * n


def _resample_np(x: np.ndarray, orig: int, new: int) -> np.ndarray:
    if orig == new:
        return x
    from scipy.signal import resample_poly
    g = math.gcd(int(orig), int(new))
    return resample_poly(x, new // g, orig // g).astype(np.float32)


def _curtail_to_multiple(x: np.ndarray, mult: Optional[int]) -> np.ndarray:
    if not mult or mult <= 1:
        return x
    return x[..., : (x.shape[-1] // mult) * mult]


class SoundDataset:
    """Audio files under `folder` (`exts`; by default FLAC and WAV, and MP3
    and WebM where the FFmpeg decoder built, as in JAX; sorted by path),
    each a float32 array at `target_sample_hz` (or a tuple, one per rate).
    `seed` seeds the crops."""

    def __init__(self, folder, *, target_sample_hz, max_length: Optional[int] = None,
                 seq_len_multiple_of=None, exts=None, seed: int = 0):
        if exts is None:
            from . import native_loader
            exts = ("flac", "wav") + (("mp3", "webm") if native_loader.ff_available() else ())
        folder = Path(folder)
        if not folder.exists():
            raise FileNotFoundError(f"folder {folder} does not exist")
        files = []
        for ext in exts:
            files.extend(folder.glob(f"**/*.{ext}"))
        if not files:
            raise ValueError(f"no sound files found in {folder}")
        self.files = sorted(files)
        self.target_sample_hz = _cast_tuple(target_sample_hz)
        num_outputs = len(self.target_sample_hz)
        self.seq_len_multiple_of = _cast_tuple(seq_len_multiple_of, num_outputs)
        if len(self.seq_len_multiple_of) != num_outputs:
            raise ValueError("one seq_len_multiple_of per target rate")
        self.max_length = max_length
        self.max_target_sample_hz = max(self.target_sample_hz)
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        data, sample_hz = load_audio(self.files[idx])
        if data.shape[0] > 1:
            data = np.mean(data, axis=0, keepdims=True)  # mono downmix
        data = _resample_np(data[0], sample_hz, self.max_target_sample_hz)
        sample_hz = self.max_target_sample_hz
        if self.max_length is not None:
            audio_length = data.shape[-1]
            if audio_length > self.max_length:
                start = self.rng.randint(0, audio_length - self.max_length)
                data = data[start: start + self.max_length]
            else:
                data = np.pad(data, (0, self.max_length - audio_length))
        outputs = []
        for rate, mult in zip(self.target_sample_hz, self.seq_len_multiple_of):
            out = _curtail_to_multiple(_resample_np(data, sample_hz, rate), mult)
            outputs.append(out.astype(np.float32))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


def _pad_to_longest(arrs):
    out = np.zeros((len(arrs), max(a.shape[-1] for a in arrs)), np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[-1]] = a
    return out


def _curtail_to_shortest(arrs):
    minlen = min(a.shape[-1] for a in arrs)
    return np.stack([a[..., :minlen] for a in arrs])


def collate_one_or_multiple_tensors(items, pad_to_longest: bool = True):
    """Collate arrays, tuples of arrays (and strings) or strings."""
    fuse = _pad_to_longest if pad_to_longest else _curtail_to_shortest
    first = items[0]
    if isinstance(first, str):
        return list(items)
    if isinstance(first, (tuple, list)):
        return tuple(list(field) if isinstance(field[0], str)
                     else fuse([np.asarray(f) for f in field]) for field in zip(*items))
    return fuse([np.asarray(i) for i in items])


class _WorkerError:
    """An exception raised in a worker, published under its ticket."""

    def __init__(self, exc):
        self.exc = exc


class _Loader:
    """An endless loader over a dataset, prefetched by worker threads. The
    batch order is fixed by the seeded shuffle: a worker claims a ticket and
    its indices under one lock, and batches are released in ticket order. A
    worker's exception is raised by `__next__` for its ticket."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 pad_to_longest: bool = True, num_workers: int = 2, prefetch: int = 4,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_to_longest = pad_to_longest
        self.prefetch = prefetch
        self.rng = random.Random(seed)
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._order = []
        self._ticket = 0      # next ticket a worker claims
        self._next_out = 0    # next ticket __next__ releases
        self._done = {}       # ticket -> batch
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(max(1, num_workers))]
        for t in self.threads:
            t.start()

    def _claim(self):
        with self._cv:
            while self._ticket - self._next_out >= self.prefetch and not self._stop.is_set():
                self._cv.wait(timeout=1.0)
            if self._stop.is_set():
                return None, None
            ticket = self._ticket
            self._ticket += 1
            while len(self._order) < self.batch_size:
                idxs = list(range(len(self.dataset)))
                if self.shuffle:
                    self.rng.shuffle(idxs)
                self._order.extend(idxs)
            batch = self._order[: self.batch_size]
            del self._order[: self.batch_size]
            return ticket, batch

    def _worker(self):
        while not self._stop.is_set():
            ticket, idxs = self._claim()
            if ticket is None:
                return
            try:
                batch = collate_one_or_multiple_tensors([self.dataset[i] for i in idxs],
                                                        self.pad_to_longest)
            except Exception as e:  # noqa: BLE001 - raised again in __next__
                batch = _WorkerError(e)
            with self._cv:
                self._done[ticket] = batch
                self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while self._next_out not in self._done:
                if self._stop.is_set():
                    raise StopIteration
                self._cv.wait(timeout=60)
            batch = self._done.pop(self._next_out)
            self._next_out += 1
            self._cv.notify_all()
        if isinstance(batch, _WorkerError):
            raise RuntimeError(f"data loader worker failed on ticket {self._next_out - 1}") \
                from batch.exc
        return batch

    def stop(self):
        """Stop the workers and join them."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self.threads:
            t.join(timeout=5)


def get_dataloader(ds, *, batch_size: int, pad_to_longest: bool = True, shuffle: bool = True,
                   num_workers: int = 2):
    """An endless, prefetched iterator of collated batches of `ds`, shuffled
    from seed 0 (the JAX package's)."""
    return _Loader(ds, batch_size, shuffle=shuffle, pad_to_longest=pad_to_longest,
                   num_workers=num_workers)
