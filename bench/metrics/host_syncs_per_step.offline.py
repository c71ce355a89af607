"""Host calls that wait for the device (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a synchronous
``cudaMemcpy``; a device-to-host copy waits through one of them) over the
engine steps of the profiled sub-window."""


def read(rec, cfg):
    t = rec.trace
    if t is None or t.steps == 0:
        return None
    return t.syncs / t.steps
