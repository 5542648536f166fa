"""Process entry points for fleet roles.

    python -m pio_tpu_torch.serving_fleet shard --shard-index 0 --n-shards 2 \
        --engine-id rec [--port 0] [--memory-budget-bytes N] [--device cpu]

Storage comes from the usual PIO_STORAGE_* environment, so a shard
process on any host mounts the same store every other pio process does.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("shard",):
        print("usage: python -m pio_tpu_torch.serving_fleet shard "
              "[options]\n(the router and in-process fleet boot via "
              "`python -m pio_tpu_torch deploy --shards N --replicas R`)",
              file=sys.stderr)
        return 2
    from pio_tpu_torch.serving_fleet.shard import main as shard_main

    return shard_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
