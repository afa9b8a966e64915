"""``docs/port.md`` maps the whole JAX package: every module of
``src/repro/`` to its counterpart in ``src/repro_torch/``, every
``pl.pallas_call`` site to its CUDA kernel (and K2's backward), every
example to its port, so the map cannot fall behind the tree."""

import _torch_env  # noqa: F401  (first: one torch thread)
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PAGE = (ROOT / "docs" / "port.md").read_text()
REF = ROOT / "src" / "repro"


def _module_rows() -> dict:
    """``reference path -> port path`` from the page's module table."""
    return dict(re.findall(r"^\| `(src/repro/[\w/]+\.py)` \| "
                           r"`(src/repro_torch/[\w/]+\.py)` \|", PAGE,
                           flags=re.M))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in REF.rglob("*.py")))
def test_every_reference_module_is_mapped_to_its_port(path):
    rows = _module_rows()
    assert path in rows, f"{path} missing from docs/port.md"
    assert rows[path] == path.replace("src/repro/", "src/repro_torch/", 1)
    assert (ROOT / rows[path]).is_file()


def test_every_pallas_call_site_is_mapped():
    sites = []
    for p in sorted(REF.rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"\bpl\.pallas_call\(", line):
                sites.append(f"{p.relative_to(ROOT)}:{i}")
    assert len(sites) == 3, sites
    for site in sites:
        row = [line for line in PAGE.splitlines() if f"`{site}`" in line]
        assert row, f"{site} missing from docs/port.md's kernel table"
        assert "src/repro_torch/csrc/" in row[0], row[0]
    assert re.search(r"^\| `k2_grad` \|.*segment_sum\.cu", PAGE, flags=re.M)


def test_no_row_names_a_module_that_is_gone():
    rows = _module_rows()
    assert len(rows) == len(list(REF.rglob("*.py")))
    for ref in rows:
        assert (ROOT / ref).is_file(), ref
    for example in re.findall(r"`(examples/\w+\.py)`", PAGE):
        assert (ROOT / example).is_file(), example
