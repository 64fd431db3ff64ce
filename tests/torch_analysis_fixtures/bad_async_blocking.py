"""Known-bad fixture: the port's blocking calls lexically inside
``async def``; each marked line stalls the event loop until the card
finishes.  Parsed by tests/test_torch_analysis.py, never imported."""

import asyncio
import time

import torch


async def read_verdict(pending, out, event, stream):
    ok = pending.result()  # VIOLATION: a verdict's sync on the loop
    torch.cuda.synchronize()  # VIOLATION: the whole card, on the loop
    event.synchronize()  # VIOLATION: an event's sync
    stream.synchronize()  # VIOLATION: a stream's sync
    bits = out.tolist()  # VIOLATION: a host read waits for the card
    first = out[0].item()  # VIOLATION: so does one element
    time.sleep(0.01)  # VIOLATION: a wall-clock stall
    return ok, bits, first


async def sanctioned_shapes(pending, out):
    # the sanctioned shape: the bound method handed to a worker thread
    ok = await asyncio.to_thread(pending.result)
    host = await asyncio.to_thread(out.tolist)
    return ok, host


async def suppressed(pending):
    return pending.result()  # lint: disable=async-blocking-sync


def sync_context(pending, out):
    # outside async def a sync is where it belongs
    torch.cuda.synchronize()
    return pending.result(), out.item()
