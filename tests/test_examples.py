"""The examples run end to end on CPU and detect their planted
signals."""

import sys


def test_matched_filter_example():
    sys.path.insert(0, "examples")
    import matched_filter

    assert matched_filter.main(
        ["--streams", "8", "--length", "1024", "--templates", "4",
         "--klen", "128", "--snr", "1.0", "--selfcheck"]) == 0
