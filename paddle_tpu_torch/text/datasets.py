"""Text datasets (reference ``python/paddle/text/datasets/``).

Same dataset classes, same on-disk corpus formats, same sample schemas —
minus the downloader: this environment has no egress, so every class takes
``data_file=`` pointing at the already-fetched corpus (the reference's
``download=False`` path).  Parsers accept the exact archive layouts the
reference consumes (aclImdb tar.gz, ptb.*.txt, housing.data, ml-1m
ratings.dat), so corpora fetched for the reference work unchanged.
"""
from __future__ import annotations

import re
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.errors import InvalidArgumentError
from ..io.dataset import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Movielens", "WMT14",
           "WMT16", "Conll05st"]


def _require(data_file: Optional[str], what: str) -> str:
    if not data_file:
        raise InvalidArgumentError(
            "%s needs data_file= (no downloader in this build: fetch the "
            "corpus the reference uses and pass its path)" % what)
    return data_file


class Imdb(Dataset):
    """IMDB sentiment (imdb.py:33 parity): aclImdb tar, pos/neg dirs.

    Samples: (int64 word-id sequence, int64 label) with a frequency-cutoff
    vocabulary built from the train split — the reference's schema.
    """

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150):
        self.data_file = _require(data_file, "Imdb")
        if mode not in ("train", "test"):
            raise InvalidArgumentError("mode must be train|test")
        self.mode = mode
        self.word_idx = self._build_word_dict(cutoff)
        self.docs, self.labels = self._load(mode)

    def _iter_texts(self, pattern: "re.Pattern"):
        with tarfile.open(self.data_file) as tf:
            for member in tf.getmembers():
                if pattern.match(member.name):
                    f = tf.extractfile(member)
                    if f is not None:
                        yield member.name, f.read().decode(
                            "utf-8", errors="ignore")

    def _build_word_dict(self, cutoff: int) -> Dict[str, int]:
        pattern = re.compile(r"aclImdb/train/((pos)|(neg))/.*\.txt$")
        freq: Dict[str, int] = {}
        for _, text in self._iter_texts(pattern):
            for w in text.lower().split():
                freq[w] = freq.get(w, 0) + 1
        # frequency cutoff, then rank by (-freq, word); <unk> is last
        kept = sorted((w for w, c in freq.items() if c >= cutoff),
                      key=lambda w: (-freq[w], w))
        word_idx = {w: i for i, w in enumerate(kept)}
        word_idx["<unk>"] = len(kept)
        return word_idx

    def _load(self, mode: str) -> Tuple[List[np.ndarray], List[int]]:
        unk = self.word_idx["<unk>"]
        docs, labels = [], []
        for label, name in ((0, "neg"), (1, "pos")):
            pattern = re.compile(
                r"aclImdb/%s/%s/.*\.txt$" % (mode, name))
            for _, text in self._iter_texts(pattern):
                ids = [self.word_idx.get(w, unk)
                       for w in text.lower().split()]
                docs.append(np.asarray(ids, np.int64))
                labels.append(label)
        return docs, labels

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], np.int64(self.labels[i])


class Imikolov(Dataset):
    """PTB language-model n-grams (imikolov.py:31 parity).

    ``type='ngram'`` yields N-token windows; ``type='seq'`` yields
    <s> … </s> wrapped id sequences.  Vocabulary: words with freq >=
    ``min_word_freq`` from train, plus <s>, </s>, <unk>.
    """

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 data_type: str = "ngram", window_size: int = 5,
                 min_word_freq: int = 50):
        self.data_file = _require(data_file, "Imikolov")
        if data_type not in ("ngram", "seq"):
            raise InvalidArgumentError("data_type must be ngram|seq")
        self.window_size = window_size
        self.word_idx = self._build_dict(min_word_freq)
        self.data = self._load(mode, data_type)

    def _read_lines(self, split: str) -> List[List[str]]:
        member = "./simple-examples/data/ptb.%s.txt" % split
        with tarfile.open(self.data_file) as tf:
            names = tf.getnames()
            target = member if member in names else member[2:]
            f = tf.extractfile(target)
            return [l.strip().split()
                    for l in f.read().decode("utf-8").splitlines()]

    def _build_dict(self, min_freq: int) -> Dict[str, int]:
        freq: Dict[str, int] = {}
        for words in self._read_lines("train"):
            for w in words:
                freq[w] = freq.get(w, 0) + 1
        freq.pop("<unk>", None)
        kept = sorted(((w, c) for w, c in freq.items() if c >= min_freq),
                      key=lambda kv: (-kv[1], kv[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        word_idx["<s>"] = len(word_idx)
        word_idx["<e>"] = len(word_idx)
        return word_idx

    def _load(self, mode: str, data_type: str) -> List[np.ndarray]:
        unk = self.word_idx["<unk>"]
        s, e = self.word_idx["<s>"], self.word_idx["<e>"]
        out = []
        for words in self._read_lines(mode):
            ids = [s] + [self.word_idx.get(w, unk) for w in words] + [e]
            if data_type == "seq":
                out.append(np.asarray(ids, np.int64))
            else:
                n = self.window_size
                for i in range(len(ids) - n + 1):
                    out.append(np.asarray(ids[i:i + n], np.int64))
        return out

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class UCIHousing(Dataset):
    """Boston housing regression (uci_housing.py parity): housing.data,
    14 whitespace columns, feature-wise max-min normalization from the full
    file, 80/20 train/test split — the reference's exact recipe."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 feature_num: int = 14, ratio: float = 0.8):
        path = _require(data_file, "UCIHousing")
        raw = np.fromfile(path, sep=" ", dtype=np.float32)
        if raw.size % feature_num:
            raise InvalidArgumentError(
                "housing.data size %d not divisible by %d columns"
                % (raw.size, feature_num))
        data = raw.reshape(-1, feature_num)
        maxs, mins = data.max(axis=0), data.min(axis=0)
        avgs = data.mean(axis=0)
        span = np.where(maxs > mins, maxs - mins, 1.0)
        data[:, :-1] = (data[:, :-1] - avgs[:-1]) / span[:-1]
        offset = int(data.shape[0] * ratio)
        self.data = data[:offset] if mode == "train" else data[offset:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i]
        return row[:-1].astype(np.float32), row[-1:].astype(np.float32)


class Movielens(Dataset):
    """MovieLens ratings (movielens.py parity): ml-1m archive with
    ``ratings.dat`` (user::movie::rating::ts), ``users.dat``,
    ``movies.dat``.  Samples: (user_id, gender, age, job, movie_id,
    rating) int/float arrays — the reference's feature tuple, flattened."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0):
        self.data_file = _require(data_file, "Movielens")
        users, movies, ratings = self._parse()
        rng = np.random.RandomState(rand_seed)
        keep_test = rng.rand(len(ratings)) < test_ratio
        sel = keep_test if mode == "test" else ~keep_test
        self.samples = [r for r, k in zip(ratings, sel) if k]
        self.users, self.movies = users, movies

    def _read(self, name: str) -> List[str]:
        with tarfile.open(self.data_file) as tf:
            for n in tf.getnames():
                if n.endswith(name):
                    return tf.extractfile(n).read().decode(
                        "latin1").splitlines()
        raise InvalidArgumentError("archive lacks %s" % name)

    def _parse(self):
        users = {}
        for line in self._read("users.dat"):
            uid, gender, age, job, _zip = line.split("::")
            users[int(uid)] = (0 if gender == "M" else 1, int(age), int(job))
        movies = {}
        for line in self._read("movies.dat"):
            mid, title, genres = line.split("::")
            movies[int(mid)] = (title, genres.split("|"))
        ratings = []
        for line in self._read("ratings.dat"):
            uid, mid, rating, _ts = line.split("::")
            uid, mid = int(uid), int(mid)
            g, a, j = users[uid]
            ratings.append((uid, g, a, j, mid, float(rating)))
        return users, movies, ratings

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        uid, g, a, j, mid, r = self.samples[i]
        return (np.int64(uid), np.int64(g), np.int64(a), np.int64(j),
                np.int64(mid), np.float32(r))


_WMT_START, _WMT_END, _WMT_UNK = "<s>", "<e>", "<unk>"
_WMT_UNK_IDX = 2


class WMT14(Dataset):
    """WMT14 en→fr translation (wmt14.py parity).

    Archive layout (the reference's preprocessed wmt14 tar): ``*src.dict`` /
    ``*trg.dict`` (one token per line, rank = id) and ``<mode>/<mode>``
    files of tab-separated "source<TAB>target" sentence pairs.  Samples:
    (src_ids, trg_ids, trg_ids_next) int64 arrays with <s>/<e> framing;
    pairs longer than 80 tokens are dropped, as in the reference.
    """

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 dict_size: int = -1):
        self.data_file = _require(data_file, "WMT14")
        if mode not in ("train", "test", "gen"):
            raise InvalidArgumentError("mode must be train|test|gen")
        self.mode = mode
        self.dict_size = dict_size if dict_size > 0 else 2 ** 31
        self.src_ids: List[np.ndarray] = []
        self.trg_ids: List[np.ndarray] = []
        self.trg_ids_next: List[np.ndarray] = []
        self._load()

    def _to_dict(self, f, size: int) -> Dict[str, int]:
        out = {}
        for i, line in enumerate(f.read().decode("utf-8").splitlines()):
            if i >= size:
                break
            out[line.strip()] = i
        return out

    def _load(self) -> None:
        with tarfile.open(self.data_file) as tf:
            names = tf.getnames()
            src_dict_name = [n for n in names if n.endswith("src.dict")]
            trg_dict_name = [n for n in names if n.endswith("trg.dict")]
            if len(src_dict_name) != 1 or len(trg_dict_name) != 1:
                raise InvalidArgumentError(
                    "archive must carry exactly one src.dict and trg.dict")
            self.src_dict = self._to_dict(
                tf.extractfile(src_dict_name[0]), self.dict_size)
            self.trg_dict = self._to_dict(
                tf.extractfile(trg_dict_name[0]), self.dict_size)
            data_suffix = "%s/%s" % (self.mode, self.mode)
            for name in (n for n in names if n.endswith(data_suffix)):
                for line in tf.extractfile(name).read() \
                        .decode("utf-8").splitlines():
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, _WMT_UNK_IDX)
                           for w in [_WMT_START] + parts[0].split()
                           + [_WMT_END]]
                    trg = [self.trg_dict.get(w, _WMT_UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(np.asarray(src, np.int64))
                    self.trg_ids.append(np.asarray(
                        [self.trg_dict[_WMT_START]] + trg, np.int64))
                    self.trg_ids_next.append(np.asarray(
                        trg + [self.trg_dict[_WMT_END]], np.int64))

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, i):
        return self.src_ids[i], self.trg_ids[i], self.trg_ids_next[i]


class WMT16(Dataset):
    """WMT16 en↔de translation (wmt16.py parity).

    Archive layout (the reference's wmt16.tar.gz): ``wmt16/train``,
    ``wmt16/test``, ``wmt16/val`` files of tab-separated "en<TAB>de"
    sentence pairs — no bundled dictionaries; vocabularies are built from
    the train split at load time: <s>/<e>/<unk> first, then words by
    descending train frequency, truncated to ``src/trg_dict_size``.
    ``lang`` selects the source column ('en' or 'de').  Samples:
    (src_ids, trg_ids, trg_ids_next), <s>/<e>-framed like the reference.
    """

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = -1, trg_dict_size: int = -1,
                 lang: str = "en"):
        self.data_file = _require(data_file, "WMT16")
        if mode.lower() not in ("train", "test", "val"):
            raise InvalidArgumentError("mode should be train|test|val")
        if lang not in ("en", "de"):
            raise InvalidArgumentError("lang should be en|de")
        self.mode = mode.lower()
        self.lang = lang
        self.src_dict = self._build_dict(
            0 if lang == "en" else 1, src_dict_size)
        self.trg_dict = self._build_dict(
            1 if lang == "en" else 0, trg_dict_size)
        self.src_ids: List[np.ndarray] = []
        self.trg_ids: List[np.ndarray] = []
        self.trg_ids_next: List[np.ndarray] = []
        self._load()

    def _pairs(self, split: str):
        with tarfile.open(self.data_file) as tf:
            data = tf.extractfile("wmt16/%s" % split).read().decode("utf-8")
        for line in data.splitlines():
            parts = line.strip().split("\t")
            if len(parts) == 2:
                yield parts

    def _build_dict(self, col: int, dict_size: int) -> Dict[str, int]:
        freq: Dict[str, int] = {}
        for parts in self._pairs("train"):
            for w in parts[col].split():
                freq[w] = freq.get(w, 0) + 1
        vocab = {_WMT_START: 0, _WMT_END: 1, _WMT_UNK: 2}
        cap = dict_size if dict_size > 0 else len(freq) + 3
        for w, _c in sorted(freq.items(), key=lambda kv: kv[1],
                            reverse=True):
            if len(vocab) >= cap:
                break
            vocab[w] = len(vocab)
        return vocab

    def _load(self) -> None:
        start, end, unk = 0, 1, _WMT_UNK_IDX
        src_col = 0 if self.lang == "en" else 1
        for parts in self._pairs(self.mode):
            src = [start] + [self.src_dict.get(w, unk)
                             for w in parts[src_col].split()] + [end]
            trg = [self.trg_dict.get(w, unk)
                   for w in parts[1 - src_col].split()]
            self.src_ids.append(np.asarray(src, np.int64))
            self.trg_ids.append(np.asarray([start] + trg, np.int64))
            self.trg_ids_next.append(np.asarray(trg + [end], np.int64))

    def get_dict(self, lang: str = "en"):
        return self.src_dict if lang == self.lang else self.trg_dict

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, i):
        return self.src_ids[i], self.trg_ids[i], self.trg_ids_next[i]


class Conll05st(Dataset):
    """CoNLL-2005 SRL (conll05.py parity).

    Inputs: the conll05st-release tar (``.../test.wsj/words/*.words.gz`` +
    ``.../props/*.props.gz``) and plain word/verb/target dict files, all
    passed by path (no downloader).  Each proposition becomes one sample:
    the 9-tuple (word_idx, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_idx,
    mark, label_idx) the reference emits — predicate context windows
    broadcast over the sentence, BIO labels decoded from the bracketed
    props columns.  Delta vs the reference: label ids are assigned in
    sorted tag order (its set iteration order is interpreter-dependent).
    """

    UNK_IDX = 0

    def __init__(self, data_file: Optional[str] = None,
                 word_dict_file: Optional[str] = None,
                 verb_dict_file: Optional[str] = None,
                 target_dict_file: Optional[str] = None,
                 section: str = "test.wsj"):
        import gzip

        self.data_file = _require(data_file, "Conll05st")
        self.section = section
        self.word_dict = self._load_plain_dict(
            _require(word_dict_file, "Conll05st(word_dict_file)"))
        self.predicate_dict = self._load_plain_dict(
            _require(verb_dict_file, "Conll05st(verb_dict_file)"))
        self.label_dict = self._load_label_dict(
            _require(target_dict_file, "Conll05st(target_dict_file)"))
        self.sentences: List[List[str]] = []
        self.predicates: List[str] = []
        self.labels: List[List[str]] = []
        with tarfile.open(self.data_file) as tf:
            names = tf.getnames()

            def member(sub):
                # both streams must come from the SAME section: the release
                # tar carries train/devel/test.brown/test.wsj side by side,
                # and words/props line streams are zipped positionally
                for n in names:
                    if self.section in n and sub in n and n.endswith(".gz"):
                        return tf.extractfile(n).read()
                raise InvalidArgumentError(
                    "archive lacks a %s%s*.gz member" % (self.section, sub))

            words = gzip.decompress(member("/words/")).decode("utf-8")
            props = gzip.decompress(member("/props/")).decode("utf-8")
        self._parse(words.splitlines(), props.splitlines())

    @staticmethod
    def _load_plain_dict(path: str) -> Dict[str, int]:
        with open(path, encoding="utf-8") as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(path: str) -> Dict[str, int]:
        tags = set()
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        d: Dict[str, int] = {}
        for tag in sorted(tags):
            d["B-" + tag] = len(d)
            d["I-" + tag] = len(d)
        d["O"] = len(d)
        return d

    @staticmethod
    def _decode_bio(col: List[str]) -> List[str]:
        out, cur, inside = [], "O", False
        for l in col:
            if l == "*":
                out.append("I-" + cur if inside else "O")
            elif l == "*)":
                out.append("I-" + cur)
                inside = False
            elif "(" in l and ")" in l:
                cur = l[1:l.find("*")]
                out.append("B-" + cur)
                inside = False
            elif "(" in l:
                cur = l[1:l.find("*")]
                out.append("B-" + cur)
                inside = True
            else:
                raise InvalidArgumentError("unexpected props label %r" % l)
        return out

    def _parse(self, word_lines, prop_lines) -> None:
        sentence: List[str] = []
        seg: List[List[str]] = []
        for word, prop in zip(word_lines, prop_lines):
            cols = prop.strip().split()
            if not cols:  # sentence boundary
                self._flush(sentence, seg)
                sentence, seg = [], []
            else:
                sentence.append(word.strip())
                seg.append(cols)
        self._flush(sentence, seg)

    def _flush(self, sentence, seg) -> None:
        if not seg:
            return
        columns = [[row[i] for row in seg] for i in range(len(seg[0]))]
        verbs = [v for v in columns[0] if v != "-"]
        for i, col in enumerate(columns[1:]):
            self.sentences.append(list(sentence))
            self.predicates.append(verbs[i])
            self.labels.append(self._decode_bio(col))

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def __len__(self):
        return len(self.sentences)

    def __getitem__(self, idx):
        sentence = self.sentences[idx]
        labels = self.labels[idx]
        n = len(sentence)
        v = labels.index("B-V")
        mark = [0] * n
        ctx = {}
        for off, key, pad in ((-2, "n2", "bos"), (-1, "n1", "bos"),
                              (0, "0", None), (1, "p1", "eos"),
                              (2, "p2", "eos")):
            j = v + off
            if 0 <= j < n:
                mark[j] = 1
                ctx[key] = sentence[j]
            else:
                ctx[key] = pad
        wd = self.word_dict
        unk = self.UNK_IDX
        word_idx = [wd.get(w, unk) for w in sentence]

        def bcast(tok):
            return [wd.get(tok, unk)] * n

        return (np.asarray(word_idx), np.asarray(bcast(ctx["n2"])),
                np.asarray(bcast(ctx["n1"])), np.asarray(bcast(ctx["0"])),
                np.asarray(bcast(ctx["p1"])), np.asarray(bcast(ctx["p2"])),
                np.asarray([self.predicate_dict.get(self.predicates[idx])]
                           * n),
                np.asarray(mark),
                np.asarray([self.label_dict.get(l) for l in labels]))
