"""Kafka record batches of JSON events (configuration key
``"payload": "kafka_json_events"``)."""

import numpy as np


_TYPES = (b"page_view", b"click", b"add_to_cart", b"checkout", b"search",
          b"login", b"logout", b"purchase")
_TYPE_P = (0.42, 0.2, 0.1, 0.04, 0.12, 0.05, 0.04, 0.03)
_COUNTRIES = (b"US", b"DE", b"GB", b"FR", b"IN", b"BR", b"JP", b"CA", b"ES",
              b"IT", b"NL", b"SE")
_DEVICES = (b"mobile", b"desktop", b"tablet")
_OS = (b"android", b"ios", b"windows", b"macos", b"linux")
_PAGES = (b"/", b"/catalog", b"/catalog/item", b"/cart", b"/checkout",
          b"/search", b"/account", b"/help")
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def _varint(v: int) -> bytes:
    """Kafka's zig-zag varint."""
    z = (v << 1) ^ (v >> 63)
    out = bytearray()
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


# varints of the small numbers a record takes (lengths, deltas), at once
_VAR = [_varint(v) for v in range(1 << 16)]


def _var(v: int) -> bytes:
    return _VAR[v] if v < len(_VAR) else _varint(v)


def make(lengths, rng) -> list:
    """Each record is a Kafka record batch's records section (the bytes
    Kafka compresses as one zstd frame): v2 records (length, attributes,
    timestamp and offset deltas, key, value, no headers) whose values are
    JSON events, appended while they fit; the last record is cut at the
    batch's length, as the batch's last bytes."""
    total = int(np.sum(lengths))
    n_ev = total // 180 + 1024  # events are over 250 B: never all used
    # every field of every event drawn at once
    ids = _HEX[rng.integers(0, 16, (n_ev, 32))]
    sess = _HEX[rng.integers(0, 16, (n_ev, 12))]
    users = rng.zipf(1.3, n_ev) % 200_000
    types = rng.choice(len(_TYPES), n_ev, p=_TYPE_P)
    ctry = rng.choice(len(_COUNTRIES), n_ev)
    dev = rng.choice(len(_DEVICES), n_ev, p=(0.6, 0.33, 0.07))
    oss = rng.choice(len(_OS), n_ev)
    page = rng.choice(len(_PAGES), n_ev)
    item = rng.integers(1, 50_000, n_ev)
    dur = rng.gamma(2.0, 120.0, n_ev).astype(np.int64)
    dts = rng.integers(0, 40, n_ev)
    ok = rng.random(n_ev) < 0.97
    ts0 = 1_760_000_000_000 + int(rng.integers(0, 86_400_000))
    ts = (ts0 + np.cumsum(dts)).tolist()
    ids, sess = ids.tobytes(), sess.tobytes()
    users, item, dur = users.tolist(), item.tolist(), dur.tolist()
    types, ctry, dev = types.tolist(), ctry.tolist(), dev.tolist()
    oss, page, ok = oss.tolist(), page.tolist(), ok.tolist()
    # a batch's records: timestamp deltas from the previous batch's last
    out, e, last = [], 0, ts0
    for n in lengths:
        parts, size, k, base = [], 0, 0, last
        while size < n:
            value = (b'{"event_id":"%s","ts":%d,"user_id":%d,'
                     b'"session":"s-%s","type":"%s","page":"%s/%d",'
                     b'"country":"%s","device":"%s","os":"%s",'
                     b'"duration_ms":%d,"ok":%s}' % (
                         ids[32 * e:32 * e + 32], ts[e], users[e],
                         sess[12 * e:12 * e + 12], _TYPES[types[e]],
                         _PAGES[page[e]], item[e], _COUNTRIES[ctry[e]],
                         _DEVICES[dev[e]], _OS[oss[e]], dur[e],
                         b"true" if ok[e] else b"false"))
            key = b"user-%d" % users[e]
            body = (b"\x00" + _var(ts[e] - base) + _var(k) + _var(len(key))
                    + key + _var(len(value)) + value + b"\x00")
            rec = _var(len(body)) + body
            parts.append(rec)
            size += len(rec)
            last = ts[e]
            k += 1
            e += 1
        out.append(b"".join(parts)[:n])
    return out
