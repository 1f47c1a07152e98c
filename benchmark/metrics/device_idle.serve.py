"""The device's idle share of in-service time: of the union of the profiled
requests' ``predict`` intervals, the share in which no kernel, copy or fill
ran."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_samples_per_s"


def read(ctx):
    st = ctx.stretch
    if ctx.kind != "serve" or st is None or not st.device or not st.unit_spans:
        return None
    service = sum(e - s for s, e in st.unit_spans)
    return 100.0 * (1.0 - st.busy_us(st.unit_spans) / service)
