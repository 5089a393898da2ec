"""The port's controllers, triggers, completions and revert stacks
(``cilium_tpu_torch/utils/{controller,trigger,completion,revert}.py``)
against the reference's.

tests/test_utils.py's controller, trigger, completion and revert cases run
through both packages (tests/agent_cases.py); each scenario returns what
the reference test asserts, and the two packages' answers must be equal.
"""

from __future__ import annotations

import threading
import time

import pytest

from agent_cases import agent_globals, both, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

# --- controllers ---------------------------------------------------------------------


def _runs_and_counts(pk):
    ran = threading.Event()
    mgr = pk.controller.ControllerManager()
    mgr.update_controller("t1", pk.controller.ControllerParams(do_func=ran.set))
    try:
        c = mgr.lookup("t1")
        wait_for(lambda: c.status().success_count >= 1)
        st = c.status()
        return ran.wait(2), st.success_count >= 1, st.failure_count
    finally:
        mgr.remove_all()


def _error_backoff_and_recovery(pk):
    attempts = []

    def do():
        attempts.append(time.monotonic())
        if len(attempts) < 3:
            raise RuntimeError("boom")

    mgr = pk.controller.ControllerManager()
    mgr.update_controller("t2", pk.controller.ControllerParams(do_func=do, error_retry_base=0.05))
    try:
        c = mgr.lookup("t2")
        wait_for(lambda: c.status().success_count >= 1)
        st = c.status()
        gap1, gap2 = attempts[1] - attempts[0], attempts[2] - attempts[1]
        return (st.failure_count, st.success_count >= 1, st.consecutive_errors, st.last_error,
                gap2 > gap1 * 1.5)
    finally:
        mgr.remove_all()


def _update_runs_immediately(pk):
    count = []
    mgr = pk.controller.ControllerManager()
    mgr.update_controller("t3", pk.controller.ControllerParams(do_func=lambda: count.append(1)))
    c = mgr.lookup("t3")
    first = wait_for(lambda: len(count) >= 1)
    n = len(count)
    c.update()
    again = wait_for(lambda: len(count) > n)
    return first, again, mgr.remove_controller("t3"), mgr.remove_controller("t3")


def _stop_func_called(pk):
    stopped = threading.Event()
    mgr = pk.controller.ControllerManager()
    mgr.update_controller("t4", pk.controller.ControllerParams(do_func=lambda: None, stop_func=stopped.set))
    mgr.remove_controller("t4")
    return stopped.wait(2), mgr.lookup("t4") is None


def _statuses_and_names(pk):
    mgr = pk.controller.ControllerManager()
    for name in ("b", "a", "c"):
        mgr.update_controller(name, pk.controller.ControllerParams(do_func=lambda: None, run_interval=60.0))
    try:
        wait_for(lambda: all(s.success_count >= 1 for s in mgr.statuses()))
        return sorted((s.name, s.success_count, s.failure_count) for s in mgr.statuses())
    finally:
        mgr.remove_all()


@pytest.mark.parametrize("scenario,want", [
    (_runs_and_counts, (True, True, 0)),
    (_error_backoff_and_recovery, (2, True, 0, "", True)),
    (_update_runs_immediately, (True, True, True, False)),
    (_stop_func_called, (True, True)),
    (_statuses_and_names, [("a", 1, 0), ("b", 1, 0), ("c", 1, 0)]),
], ids=["runs-and-counts", "error-backoff-and-recovery", "update-runs-immediately", "stop-func-called",
        "statuses"])
def test_controller_matches_reference(scenario, want):
    assert both(scenario) == want


# --- triggers ------------------------------------------------------------------------


def _folding_with_min_interval(pk):
    calls = []
    t = pk.trigger.Trigger(lambda: calls.append(time.monotonic()), min_interval=0.1, name="x")
    for _ in range(20):
        t.trigger()
        time.sleep(0.005)
    wait_for(lambda: calls, 2)
    time.sleep(0.25)
    t.shutdown()
    return 1 <= len(calls) <= 4, len(calls) < 2 or calls[1] - calls[0] >= 0.09


def _no_interval_runs_each_burst(pk):
    calls = []
    t = pk.trigger.Trigger(lambda: calls.append(1), name="y")
    t.trigger()
    ok = wait_for(lambda: calls, 2)
    t.shutdown()
    return ok


def _shutdown_stops_the_thread(pk):
    calls = []
    t = pk.trigger.Trigger(lambda: calls.append(1), min_interval=0.01, name="z")
    t.trigger()
    wait_for(lambda: calls, 2)
    t.shutdown()
    n = len(calls)
    t.trigger()
    t._thread.join(2)
    return len(calls) == n, not t._thread.is_alive()


@pytest.mark.parametrize("scenario,want", [
    (_folding_with_min_interval, (True, True)),
    (_no_interval_runs_each_burst, True),
    (_shutdown_stops_the_thread, (True, True)),
], ids=["folding-with-min-interval", "no-interval-runs-each-burst", "shutdown-stops-the-thread"])
def test_trigger_matches_reference(scenario, want):
    assert both(scenario) == want


# --- completions ---------------------------------------------------------------------


def _wait_all_completed(pk):
    wg = pk.completion.WaitGroup()
    c1, c2 = wg.add_completion(), wg.add_completion()
    timers = [threading.Timer(0.05, c1.complete), threading.Timer(0.08, c2.complete)]
    for t in timers:
        t.start()
    wg.wait(timeout=2)
    for t in timers:
        t.join()
    return c1.completed, c2.completed


def _deadline(pk):
    wg = pk.completion.WaitGroup()
    wg.add_completion()  # never completed
    try:
        wg.wait(timeout=0.05)
    except pk.completion.CompletionError:
        return "CompletionError"
    return "returned"


def _standalone(pk):
    c = pk.completion.Completion()
    before = c.completed
    c.complete()
    return before, c.completed, c.wait(0)


@pytest.mark.parametrize("scenario,want", [(_wait_all_completed, (True, True)), (_deadline, "CompletionError"),
                                           (_standalone, (False, True, True))],
                         ids=["wait-all", "deadline", "standalone"])
def test_completion_matches_reference(scenario, want):
    assert both(scenario) == want


# --- revert --------------------------------------------------------------------------


def _reverse_order(pk):
    order = []
    s = pk.revert.RevertStack()
    for i in (1, 2, 3):
        s.push(lambda i=i: order.append(i))
    s.revert()
    return order, len(s)


def _finalize(pk):
    order = []
    f = pk.revert.FinalizeList()
    f.append(lambda: order.append("a"))
    f.append(lambda: order.append("b"))
    f.finalize()
    return order


@pytest.mark.parametrize("scenario,want", [(_reverse_order, ([3, 2, 1], 0)), (_finalize, ["a", "b"])],
                         ids=["reverse-order", "finalize"])
def test_revert_matches_reference(scenario, want):
    assert both(scenario) == want
