#!/usr/bin/env python3
"""Where a test run's time goes, from its JUnit XML (``pytest
--junitxml=FILE``): the summed test-seconds (each test's setup, call and
teardown, as pytest records them), split into the port's tests
(``tests/test_torch_*.py``) and the others, and the costliest files.

    python3 tools/test_seconds.py run.xml [other.xml ...] [--top 20]

With two files it prints each file's seconds side by side.
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def per_file(path: str) -> collections.Counter:
    seconds = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        seconds[case.get("classname").split(".")[-1]] += float(
            case.get("time"))
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("xml", nargs="+")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    runs = [per_file(p) for p in args.xml]
    for path, run in zip(args.xml, runs):
        port = sum(s for f, s in run.items() if f.startswith("test_torch_"))
        print(f"{path}: {sum(run.values()):.1f} test-seconds "
              f"(port {port:.1f}, others {sum(run.values()) - port:.1f})")
    order = sorted(set().union(*runs), key=lambda f: -runs[0][f])
    for f in order[:args.top]:
        print("  " + "  ".join(f"{run[f]:8.1f}" for run in runs) + f"  {f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
