"""exp harness log parsing (common_parser.py analog)."""
from exp.common.runner import parse_log


def test_parse_log():
    text = """
config:model=graphsage
config:arch=arch5
Epoch 00001 | Time 1.0
test_result:epoch_time=1.2345
test_result:cache_hit_rate=0.98
noise line
"""
    out = parse_log(text)
    assert out["config:model"] == "graphsage"
    assert out["config:arch"] == "arch5"
    assert out["epoch_time"] == "1.2345"
    assert out["cache_hit_rate"] == "0.98"

