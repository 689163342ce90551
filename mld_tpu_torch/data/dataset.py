"""Host-side dataset and loaders (carried copy of the parts of
``mld_tpu/data/dataset.py`` that training reads: ``Text2MotionDataset``,
``DataLoader``, ``PrefetchDataLoader``). numpy only; the classes are kept
equal to the originals, and ``tests/test_torch_train_data.py`` holds their
source equal.

Layout-compatible with the HumanML3D/KIT-ML distribution the reference
consumes (new_joint_vecs/*.npy + texts/*.txt + split lists + Mean/Std.npy).
Parity target: mld/data/humanml/data/dataset.py:234-440
(Text2MotionDatasetV2). Every batch leaves the collator with static shapes:
motion padded to max_motion_len with a boolean mask, text pre-tokenized to
CLIP ids.
"""
from __future__ import annotations

import codecs
import os
from dataclasses import dataclass
from os.path import join as pjoin
from typing import Dict, List, Optional

import numpy as np

from .word_vectorizer import WordVectorizer


@dataclass
class TextEntry:
    caption: str
    tokens: List[str]          # "word/POS" tokens


class Text2MotionDataset:
    """name list + per-clip features + multi-caption text."""

    def __init__(self, data_root: str, split: str, mean: np.ndarray,
                 std: np.ndarray, w_vectorizer: Optional[WordVectorizer],
                 max_motion_length: int = 196, min_motion_length: int = 40,
                 max_text_len: int = 20, unit_length: int = 4,
                 fps: float = 20.0, tiny: bool = False,
                 debug: bool = False, rng: Optional[np.random.RandomState] = None,
                 with_eval_embeddings: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.w_vectorizer = w_vectorizer
        # GloVe word/POS features are only consumed by the t2m evaluators
        # (val/test); skipping them on the train split removes the dominant
        # per-sample host cost (the training step is host-bound otherwise)
        self.with_eval_embeddings = with_eval_embeddings
        self.max_motion_length = max_motion_length
        self.min_motion_length = min_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.rng = rng or np.random.RandomState(1234)

        motion_dir = pjoin(data_root, "new_joint_vecs")
        text_dir = pjoin(data_root, "texts")

        split_file = pjoin(data_root, f"{split}.txt")
        with codecs.open(split_file, "r") as f:
            id_list = [line.strip() for line in f if line.strip()]
        if tiny:
            id_list = id_list[:10]
        elif debug:
            id_list = id_list[:100]

        self.data: Dict[str, dict] = {}
        name_list: List[str] = []
        length_list: List[int] = []
        for name in id_list:
            mpath = pjoin(motion_dir, name + ".npy")
            tpath = pjoin(text_dir, name + ".txt")
            if not (os.path.exists(mpath) and os.path.exists(tpath)):
                continue
            motion = np.load(mpath)
            if len(motion) < self.min_motion_length or len(motion) >= 200:
                continue
            text_data: List[TextEntry] = []
            flag = False
            with codecs.open(tpath) as f:
                for line in f:
                    parts = line.strip().split("#")
                    if not parts[0]:
                        continue
                    caption = parts[0]
                    tokens = parts[1].split(" ") if len(parts) > 1 else []
                    f_tag = float(parts[2]) if len(parts) > 2 and parts[2] \
                        else 0.0
                    to_tag = float(parts[3]) if len(parts) > 3 and parts[3] \
                        else 0.0
                    entry = TextEntry(caption, tokens)
                    if f_tag == 0.0 and to_tag == 0.0:
                        flag = True
                        text_data.append(entry)
                    else:
                        # sub-span becomes its own sample
                        # (dataset.py:306-330 semantics)
                        sub = motion[int(f_tag * fps): int(to_tag * fps)]
                        if (len(sub) < self.min_motion_length
                                or len(sub) >= 200):
                            continue
                        new_name = f"{name}_{len(name_list)}"
                        self.data[new_name] = {
                            "motion": sub, "length": len(sub),
                            "text": [entry], "src_name": name,
                            "src_offset": int(f_tag * fps)}
                        name_list.append(new_name)
                        length_list.append(len(sub))
            if flag and text_data:
                self.data[name] = {"motion": motion, "length": len(motion),
                                   "text": text_data, "src_name": name,
                                   "src_offset": 0}
                name_list.append(name)
                length_list.append(len(motion))

        if name_list:
            order = np.argsort(length_list)
            self.name_list = [name_list[i] for i in order]
            self.length_arr = np.asarray(length_list)[order]
        else:
            self.name_list, self.length_arr = [], np.zeros(0, int)
        self.nfeats = (next(iter(self.data.values()))["motion"].shape[-1]
                       if self.data else 0)

    def __len__(self):
        return len(self.name_list)

    def _tokens_to_embeddings(self, tokens: List[str]):
        if len(tokens) < self.max_text_len:
            tokens = (["sos/OTHER"] + tokens + ["eos/OTHER"])
            sent_len = len(tokens)
            tokens += ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        else:
            tokens = (["sos/OTHER"] + tokens[: self.max_text_len]
                      + ["eos/OTHER"])
            sent_len = len(tokens)
        embs, ohots = [], []
        for token in tokens:
            vec, oh = self.w_vectorizer[token]
            embs.append(vec[None])
            ohots.append(oh[None])
        return (np.concatenate(embs, 0), np.concatenate(ohots, 0), sent_len)

    def __getitem__(self, idx: int) -> dict:
        item = self.data[self.name_list[idx]]
        motion, m_length = item["motion"], item["length"]
        entry = item["text"][self.rng.randint(len(item["text"]))]

        if self.w_vectorizer is not None and self.with_eval_embeddings:
            word_embs, pos_ohot, sent_len = self._tokens_to_embeddings(
                list(entry.tokens))
        elif self.with_eval_embeddings:
            word_embs = np.zeros((self.max_text_len + 2, 300), np.float32)
            pos_ohot = np.zeros((self.max_text_len + 2, 15), np.float32)
            sent_len = 0
        else:
            word_embs = pos_ohot = None
            sent_len = len(entry.tokens)

        # random crop to unit-length multiples (dataset.py:409-420)
        unit = self.unit_length
        coin2 = (self.rng.choice(["single", "single", "double"])
                 if unit < 10 else "single")
        if coin2 == "double":
            m_length = (m_length // unit - 1) * unit
        else:
            m_length = (m_length // unit) * unit
        start = self.rng.randint(0, len(motion) - m_length + 1)
        motion = motion[start: start + m_length]

        motion = (motion - self.mean) / self.std
        if np.isnan(motion).any():
            raise ValueError(f"nan in motion {self.name_list[idx]}")
        out = {
            "text": entry.caption,
            "text_len": sent_len,
            "motion": motion.astype(np.float32),
            "length": m_length,
            "tokens": "_".join(entry.tokens),
        }
        if word_embs is not None:
            out["word_embs"] = word_embs.astype(np.float32)
            out["pos_ohot"] = pos_ohot.astype(np.float32)
        return out


class DataLoader:
    """Minimal shuffling batch iterator over an indexable dataset."""

    def __init__(self, dataset, batch_size: int, collate_fn, shuffle=True,
                 drop_last=False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idxs = order[i: i + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(j)] for j in idxs])


class PrefetchDataLoader(DataLoader):
    """DataLoader with background-thread batch preparation.

    The reference leans on torch DataLoader worker processes; here a
    daemon thread assembles (loads, crops, collates) up to ``prefetch``
    batches ahead of the training loop so host data work overlaps device
    compute. numpy slicing/padding releases the GIL for the bulk of the
    work, and the optional C++ loader (native/loader.cc) moves the file IO
    off Python entirely.
    """

    def __init__(self, dataset, batch_size, collate_fn, shuffle=True,
                 drop_last=False, seed: int = 0, prefetch: int = 3):
        super().__init__(dataset, batch_size, collate_fn, shuffle,
                         drop_last, seed)
        self.prefetch = max(1, prefetch)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def producer():
            try:
                for batch in super(PrefetchDataLoader, self).__iter__():
                    q.put(batch)
            except BaseException as e:  # surface in the consumer — a bare
                q.put(e)                # finally would end the epoch early
                return
            finally:
                q.put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
