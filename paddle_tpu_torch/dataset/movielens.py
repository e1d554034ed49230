"""Legacy MovieLens ml-1m readers (``paddle.dataset.movielens``).

Reference: ``python/paddle/dataset/movielens.py:45-300``. Samples are
``usr.value() + mov.value() + [[rating]]`` with rating rescaled to
[-5, 5] by ``r*2-5`` and a per-line random train/test split. Place
``ml-1m.zip`` in ``DATA_HOME/movielens/``. Delta vs the reference:
title-word and category ids are assigned in sorted order (its set
iteration order is interpreter-dependent). The train/test split stream
is NOT a delta: the reference seeds the global numpy RNG
(``np.random.seed(rand_seed)`` then ``np.random.random()``,
``python/paddle/dataset/movielens.py:152,157``) and a fresh
``np.random.RandomState(rand_seed).random_sample()`` yields the
bit-identical MT19937 sequence — same per-line membership — without
mutating global RNG state.
"""
from __future__ import annotations

import functools
import re
import zipfile

import numpy as np

from . import common

__all__ = []

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    """Movie id, title and categories."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [CATEGORIES_DICT[c] for c in self.categories],
                [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return "<MovieInfo id(%d), title(%s), categories(%s)>" % (
            self.index, self.title, self.categories)


class UserInfo:
    """User id, gender, age bucket and job."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return "<UserInfo id(%d), gender(%s), age(%d), job(%d)>" % (
            self.index, "M" if self.is_male else "F",
            age_table[self.age], self.job_id)


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
USER_INFO = None


def _init():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO
    fn = common.local_path("movielens", "ml-1m.zip")
    if MOVIE_INFO is not None:
        return fn
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    MOVIE_INFO = {}
    title_words, categories = set(), set()
    with zipfile.ZipFile(fn) as package:
        with package.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode("latin1").strip().split("::")
                cats = cats.split("|")
                categories.update(cats)
                title = pattern.match(title).group(1)
                MOVIE_INFO[int(mid)] = MovieInfo(mid, cats, title)
                title_words.update(w.lower() for w in title.split())
        MOVIE_TITLE_DICT = {w: i for i, w in enumerate(sorted(title_words))}
        CATEGORIES_DICT = {c: i for i, c in enumerate(sorted(categories))}
        USER_INFO = {}
        with package.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = \
                    line.decode("latin1").strip().split("::")
                USER_INFO[int(uid)] = UserInfo(uid, gender, age, job)
    return fn


def _reader(rand_seed=0, test_ratio=0.1, is_test=False):
    fn = _init()
    # same MT19937 stream as the reference's np.random.seed(rand_seed) +
    # np.random.random() split, without touching global RNG state
    rng = np.random.RandomState(rand_seed)
    with zipfile.ZipFile(fn) as package:
        with package.open("ml-1m/ratings.dat") as f:
            for line in f:
                if (rng.random_sample() < test_ratio) == is_test:
                    uid, mid, rating, _ts = \
                        line.decode("latin1").strip().split("::")
                    usr = USER_INFO[int(uid)]
                    mov = MOVIE_INFO[int(mid)]
                    rating = float(rating) * 2 - 5.0
                    yield usr.value() + mov.value() + [[rating]]


def _reader_creator(**kwargs):
    return lambda: _reader(**kwargs)


train = functools.partial(_reader_creator, is_test=False)
test = functools.partial(_reader_creator, is_test=True)


def get_movie_title_dict():
    _init()
    return MOVIE_TITLE_DICT


def movie_categories():
    _init()
    return CATEGORIES_DICT


def max_movie_id():
    _init()
    return max(m.index for m in MOVIE_INFO.values())


def max_user_id():
    _init()
    return max(u.index for u in USER_INFO.values())


def max_job_id():
    _init()
    return max(u.job_id for u in USER_INFO.values())


def user_info():
    _init()
    return USER_INFO


def movie_info():
    _init()
    return MOVIE_INFO


def fetch():
    _init()
