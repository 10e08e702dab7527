"""Count the attempts that tests/test_torch_diagnose.py's retrying
end-to-end tests need.

    JAX_PLATFORMS=cpu python tools/torch_retry_attempts.py CASE [RUNS]

CASE is ``chaos:<name>`` (a case of ``test_chaos_incidents_equal_to_jax``:
slow-link, straggler, clean) or the name of another test that retries
through ``on_one_attempt``.  The test runs RUNS times (default 10) with
``on_one_attempt`` wrapped to record the attempt that passed (null: none
of ``E2E_ATTEMPTS``), and one JSON line ``{CASE: [attempts...]}`` is
printed.  Run from the root of the checkout; the test module imports the
JAX package, as the CPU tests do.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "tests"), str(REPO)]

import test_torch_diagnose as td  # noqa: E402


def main() -> int:
    case, runs = sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 10
    attempts: list[int | None] = []

    def counted(check) -> None:
        for attempt in range(1, td.E2E_ATTEMPTS + 1):
            try:
                check()
            except AssertionError:
                continue
            attempts.append(attempt)
            return
        attempts.append(None)

    td.on_one_attempt = counted
    for _ in range(runs):
        if case.startswith("chaos:"):
            td.test_chaos_incidents_equal_to_jax(case.split(":", 1)[1])
        else:
            getattr(td, case)()
    print(json.dumps({case: attempts}))
    return 0 if None not in attempts else 1


if __name__ == "__main__":
    sys.exit(main())
