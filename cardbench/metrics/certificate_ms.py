"""The certificate inside the one-shot program: the card's stream time in
``stage/certificate_build/<name>`` (both forest passes and the
compaction) per request."""
from cardbench.stream_spans import per_request_device_ms


def read(run):
    return per_request_device_ms(
        run, lambda name: name.startswith("stage/certificate_build/"))
