"""data_wait_ms: the training thread's mean wait for a batch, in ms a step,
over the window's steps (the trainer's `train/data_time`; a group's wait
spread over its steps).  Layer: host data."""


def read(rec):
    waits = [r['train/data_time'] for r in rec['logs']
             if 'train/data_time' in r]
    return 1e3 * sum(waits) / len(waits) if waits else None
