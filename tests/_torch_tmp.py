"""Temporary directories that go as soon as their test or module ends.

The port's trainers and converters write checkpoints of a few hundred MB
each (two ResNets and Adam's moments).  pytest keeps every test's
directory until the session ends, and the last three sessions' after
that, so a suite of such tests holds tens of GB of disk.  A test module
that writes checkpoints imports both fixtures, which override pytest's
own in that module only:

    from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401

``tmp_path`` is removed when its test ends, whatever the outcome, and
every directory a module-scoped fixture made with
``tmp_path_factory.mktemp`` when the module's last test ends.
"""

import shutil

import pytest


class _RemovingFactory:
    """pytest's TempPathFactory, noting each directory it makes."""

    def __init__(self, factory):
        self._factory = factory
        self.made = []

    def mktemp(self, basename, numbered=True):
        path = self._factory.mktemp(basename, numbered)
        self.made.append(path)
        return path

    def __getattr__(self, name):
        return getattr(self._factory, name)


@pytest.fixture(scope="module")
def tmp_path_factory(tmp_path_factory):
    factory = _RemovingFactory(tmp_path_factory)
    yield factory
    for path in factory.made:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
