import pytest


@pytest.fixture(autouse=True)
def _answers_kept_apart(tmp_path, monkeypatch):
    """A test's runs keep their reference answers in its own directory,
    not in the checkout's ``mzbench/.cache/``."""
    from mzbench import cache

    monkeypatch.setattr(cache, "DIR", str(tmp_path / "answers"))
