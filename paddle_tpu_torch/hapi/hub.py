"""Model hub (``paddle.hub``): load entrypoints from a repo's hubconf.py
(a copy of the reference's ``hapi/hub.py``; ``$PADDLE_HUB_DIR`` or
``HUB_DIR`` moves the cache).

Reference: ``python/paddle/hapi/hub.py:169-330`` (list/help/load over a
``hubconf.py`` protocol; github/gitee archives cached under
``~/.cache/paddle/hub``). The ``local`` source is fully supported; remote
sources resolve only from an existing cache directory — this build runs
with zero network egress, so a cache miss raises instead of downloading.
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

MODULE_HUBCONF = "hubconf.py"
VAR_DEPENDENCY = "dependencies"
# ``$PADDLE_HUB_DIR`` or this attribute redirects the hub cache
HUB_DIR = os.environ.get("PADDLE_HUB_DIR") or os.path.expanduser(
    os.path.join("~", ".cache", "paddle", "hub"))
_SOURCES = ("github", "gitee", "local")


def _import_hubconf(repo_dir):
    path = os.path.join(repo_dir, MODULE_HUBCONF)
    if not os.path.isfile(path):
        raise RuntimeError("no %s found in %r" % (MODULE_HUBCONF, repo_dir))
    spec = importlib.util.spec_from_file_location("hubconf", path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(repo_dir)
    _check_dependencies(module)
    return module


def _check_dependencies(module):
    deps = getattr(module, VAR_DEPENDENCY, None) or []
    missing = [d for d in deps if importlib.util.find_spec(d) is None]
    if missing:
        raise RuntimeError("Missing dependencies: %s" % ", ".join(missing))


def _resolve_repo(repo, source, force_reload):
    if source not in _SOURCES:
        raise ValueError(
            'Unknown source: "%s". Allowed values: "github" | "gitee" | '
            '"local".' % source)
    if source == "local":
        return repo
    # remote source: "owner/name[:branch]" → the reference's cache layout
    # (~/.cache/paddle/hub/<owner>_<name>_<branch>); zero-egress build, so
    # the cache must already exist
    if ":" in repo:
        repo, branch = repo.split(":", 1)
    else:
        branch = "main" if source == "github" else "master"
    owner, _, name = repo.partition("/")
    # branch refs like "feature/x" flatten to one path component, matching
    # the reference's ~/.cache/paddle/hub/<owner>_<name>_<branch> layout
    cached = os.path.join(
        HUB_DIR, "_".join([owner, name, branch.replace("/", "_")]))
    if os.path.isdir(cached):
        # zero-egress build: force_reload cannot re-download, so the
        # existing checkout is served either way
        if force_reload:
            sys.stderr.write(
                "paddle.hub: force_reload ignored (no-egress build); "
                "using cache at %s\n" % cached)
        return cached
    raise RuntimeError(
        "hub cache miss for %r (looked in %s) and this build has no "
        "network egress; clone the repo and use source='local'"
        % (repo, cached))


def _entrypoint(module, name):
    if not isinstance(name, str):
        raise ValueError("Invalid input: model should be a str of function "
                         "name")
    fn = getattr(module, name, None)
    if fn is None or not callable(fn):
        raise RuntimeError("Cannot find callable %s in hubconf" % name)
    return fn


def list(repo_dir, source="github", force_reload=False):  # noqa: A001
    """All public callable entrypoints exposed by the repo's hubconf."""
    module = _import_hubconf(_resolve_repo(repo_dir, source, force_reload))
    return [n for n in dir(module)
            if callable(getattr(module, n)) and not n.startswith("_")]


def help(repo_dir, model, source="github", force_reload=False):  # noqa: A001
    """The docstring of one hubconf entrypoint."""
    module = _import_hubconf(_resolve_repo(repo_dir, source, force_reload))
    return _entrypoint(module, model).__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    """Call a hubconf entrypoint and return its result (typically a
    constructed ``nn.Layer``)."""
    module = _import_hubconf(_resolve_repo(repo_dir, source, force_reload))
    return _entrypoint(module, model)(**kwargs)
