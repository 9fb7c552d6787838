"""Spans of the port's recorder (perfcount.span) for the CPU tests.

``with Tracing() as rec:`` turns the recorder on for the block, its earlier
spans dropped; afterwards ``rec.spans`` holds what it recorded and
``rec.stages("map.")`` the stages of one layer.
"""

from anyfeature_vslam_tpu_torch import perfcount


class Tracing:
    def __enter__(self):
        perfcount.clear_spans()
        perfcount.trace_enabled = True
        return self

    def __exit__(self, *exc):
        perfcount.trace_enabled = False
        self.spans = perfcount.spans()
        perfcount.clear_spans()
        return False

    def stages(self, prefix: str) -> dict:
        """{stage: number of spans} of the spans named prefix + stage."""
        out = {}
        for s in self.spans:
            if s.name.startswith(prefix):
                stage = s.name[len(prefix):]
                out[stage] = out.get(stage, 0) + 1
        return out
