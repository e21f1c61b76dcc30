"""Repository-wide pytest settings: the order in which pytest-xdist's
``--dist loadfile`` hands out the test files.

xdist hands the files out largest first by number of tests (its
``--loadscope-reorder`` default).  The costliest files of this suite hold
few tests, each a long JAX compile of a Pallas kernel in interpret mode
(``tests/test_megakernel.py``: 5 tests, most of a worker's run), so that
order starts them last and the whole run waits on them.  Collection order
(file names) starts them among the first files.

xdist also gives a worker its next file while two of its tests are still
unfinished, so a costly file can wait behind another one on a busy
worker while others go idle.  Here a worker takes its next file when one
test is left, the least that keeps it running: it starts a test only once
the next is queued.  ``tools/xdist_schedule_sim.py`` replays a run's junit
times under both rules.
"""
import pytest


def pytest_configure(config):
    if (config.pluginmanager.hasplugin("xdist")
            and hasattr(config.option, "loadscopereorder")):
        config.option.loadscopereorder = False
        config.pluginmanager.register(_NextFileWhenIdle(),
                                      "next-file-when-idle")


class _NextFileWhenIdle:
    @pytest.hookimpl(tryfirst=True)
    def pytest_xdist_make_scheduler(self, config, log):
        if config.getvalue("dist") != "loadfile":
            return None
        from xdist.scheduler import LoadFileScheduling

        class Scheduling(LoadFileScheduling):
            def _reschedule(self, node):
                # xdist's own, with 1 where it has 2
                if node.shutting_down:
                    return
                if not self.workqueue:
                    node.shutdown()
                    return
                if self._pending_of(self.assigned_work[node]) > 1:
                    return
                self._assign_work_unit(node)

        return Scheduling(config, log)
