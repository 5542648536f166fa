"""App create/delete orchestration shared by the CLI and the admin server.

Parity target: reference tools/.../console/App.scala (create: app + default
event namespace + first access key; delete: cascading key/channel/event
cleanup) and admin/CommandClient.scala, which both drive the same sequence.
"""

from __future__ import annotations

from pio_tpu_torch.data.dao import AccessKey, App, Channel
from pio_tpu_torch.data.storage import Storage, StorageError


def create_app(
    storage: Storage,
    name: str,
    description: str | None = None,
    app_id: int = 0,
    access_key: str = "",
) -> tuple[int, str] | None:
    """Create an app, init its event namespace, mint its first access key.
    Returns (app_id, key), or None if the name is taken."""
    new_id = storage.get_metadata_apps().insert(App(app_id, name, description))
    if new_id is None:
        return None
    storage.get_events().init(new_id)
    key = storage.get_metadata_access_keys().insert(
        AccessKey(access_key, new_id, ())
    )
    return new_id, key


def delete_app(storage: Storage, app: App) -> None:
    """Cascading delete: access keys, per-channel event data + channels,
    default-channel event data, then the app record."""
    keys = storage.get_metadata_access_keys()
    channels = storage.get_metadata_channels()
    for k in keys.get_by_appid(app.id):
        keys.delete(k.key)
    for ch in channels.get_by_appid(app.id):
        storage.get_events().remove(app.id, ch.id)
        channels.delete(ch.id)
    storage.get_events().remove(app.id)
    storage.get_metadata_apps().delete(app.id)


def delete_app_data(
    storage: Storage, app: App, channel_id: int | None = None
) -> None:
    """Wipe and re-init event data for one channel (or the default)."""
    storage.get_events().remove(app.id, channel_id)
    storage.get_events().init(app.id, channel_id)


def _namespaces(
    channels_dao, app_id: int, channel_name: str | None
) -> list[tuple[str, int | None]]:
    """[(label, channel_id)] for an app: the default namespace plus every
    registered channel. Labels stay unique even if a user names a channel
    literally "default" (the default NAMESPACE is channel_id None; such a
    channel is a distinct namespace and must not be skipped)."""
    chans = channels_dao.get_by_appid(app_id)
    if channel_name is not None:
        match = [c for c in chans if c.name == channel_name]
        if not match:
            raise ValueError(f"Channel {channel_name} does not exist.")
        return [(channel_name, match[0].id)]
    out: list[tuple[str, int | None]] = [("default", None)]
    for c in sorted(chans, key=lambda c: c.name):
        label = c.name if c.name != "default" else f"default (channel {c.id})"
        out.append((label, c.id))
    return out


def trim_copy(
    storage: Storage,
    src_app: App,
    dst_app: App,
    start_time=None,
    until_time=None,
    channel_name: str | None = None,
) -> dict[str, int]:
    """Copy src app's events within [start_time, until_time) into dst app —
    the reference trim-app workflow (examples/experimental/
    scala-parallel-trim-app/src/main/scala/DataSource.scala:31-51: windowed
    PEvents.find -> write into a destination app that MUST be empty, so a
    botched window can never destroy the only copy).

    With channel_name=None every namespace is copied (the default one plus
    each named channel, which is created in dst under the same name —
    channel ids are app-scoped, so the destination always gets its OWN
    channels). With a channel_name only that channel is copied. Either
    way the destination app must be ENTIRELY empty first. Returns
    {namespace_label: events_copied}."""
    ev = storage.get_events()
    channels = storage.get_metadata_channels()

    # whole-app emptiness guard: default namespace + every dst channel
    for ch in [None] + [c.id for c in channels.get_by_appid(dst_app.id)]:
        try:
            probe = next(
                iter(ev.find(dst_app.id, channel_id=ch, limit=1)), None)
        except StorageError:  # uninitialized namespace = empty
            continue
        if probe is not None:
            raise ValueError(
                f"destination app {dst_app.name!r} is not empty; trim "
                "refuses to mix into existing data (reference TrimApp "
                "contract)"
            )

    pairs = _namespaces(channels, src_app.id, channel_name)

    counts: dict[str, int] = {}
    for name, src_ch in pairs:
        if src_ch is None:
            dst_ch = None
        else:
            existing = {c.name: c.id
                        for c in channels.get_by_appid(dst_app.id)}
            dst_ch = existing.get(name)
            if dst_ch is None:
                dst_ch = channels.insert(Channel(0, name, dst_app.id))
        ev.init(dst_app.id, dst_ch)
        n = 0
        try:
            found = ev.find(
                src_app.id, channel_id=src_ch,
                start_time=start_time, until_time=until_time, limit=-1,
            )
        except StorageError:  # src namespace never initialized
            found = []
        for event in found:
            ev.insert(event, dst_app.id, dst_ch)
            n += 1
        counts[name] = n
    return counts


def cleanup_events(
    storage: Storage,
    app: App,
    until_time,
    channel_name: str | None = None,
) -> dict[str, int]:
    """Delete events with event_time < until_time IN PLACE — the reference
    cleanup-app workflow (examples/experimental/scala-cleanup-app/src/main/
    scala/DataSource.scala:31-66: windowed PEvents.find -> per-event
    LEvents.futureDelete). With channel_name=None every namespace is
    cleaned. Returns {namespace_label: events_deleted}."""
    if until_time is None:
        raise ValueError("cleanup requires an --until cutoff time")
    ev = storage.get_events()
    channels = storage.get_metadata_channels()
    pairs = _namespaces(channels, app.id, channel_name)
    counts: dict[str, int] = {}
    for name, ch in pairs:
        try:
            doomed = [
                e.event_id
                for e in ev.find(app.id, channel_id=ch,
                                 until_time=until_time, limit=-1)
                if e.event_id
            ]
        except StorageError:  # uninitialized namespace: nothing to clean
            counts[name] = 0
            continue
        # a backend failure (e.g. remote store unreachable) must RAISE,
        # not report a successful no-op — retention crons trust this count
        counts[name] = ev.delete_many(doomed, app.id, ch)
    return counts
