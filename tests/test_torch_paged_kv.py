"""Host accounting of the port's PagedKVPool: the cases of
tests/test_paged_kv.py (TestPool), run in the port's subprocess.

A budget beyond the slot's window is refused with no side effects;
re-reserve replaces; reserve and release round-trip through the device
page-table row and its host mirror; an exhausted pool refuses; max_len must
be page-aligned; the pool is smaller than dense slots; a device failure
while reserving rolls the host bookkeeping back exactly (the old mapping
and free list, also when the new reservation is larger than the old one);
a failed release still frees the pages; released buffers come back as
zeros.
"""

import json

import pytest

from torch_port import run_port

CASES = (
    "beyond_window", "rereserve_replaces", "roundtrip", "exhausted", "alignment",
    "smaller_than_dense", "reserve_failure_rolls_back", "release_failure_frees",
    "elastic_buffers",
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = run_port("paged_pool", {}, tmp_path_factory.mktemp("torch_paged_kv"))
    return json.loads(str(out["results"]))


@pytest.mark.parametrize("case", CASES)
def test_pool_accounting(results, case):
    checks = results[case]
    assert checks and all(checks), checks
