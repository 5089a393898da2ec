"""Seeded L3/L4 worlds for the port's datapath tests.

Each builder takes ``m``, a namespace of one package's host map classes
(``CtMap``, ``CtKey4``, ``CtKey6``, ``LbMap``, ``IpcacheMap``,
``PolicyMap``, ``LxcMap``, ``EndpointInfo``), and a ``random.Random``, so
the JAX package and the port build the same maps from one seed.  The
packet generators return numpy int32 arrays (addresses as uint32 bit
patterns).  Every world covers the traps a direct translation can miss:
addresses and tunnel endpoints at or above 2^31, ports up to 65,535, an
L4 service beside a wildcard-port one on the same VIP, a service without
backends, /0 and /128 prefixes, equal prefixes with different values,
expired CT entries (against a fixed clock), and both CT orientations at
node ingress.
"""

from __future__ import annotations

import ipaddress

import numpy as np

PROTO_TCP = 6
PROTO_UDP = 17
DIR_INGRESS = 0
DIR_EGRESS = 1
HOST_ID = 1
WORLD_ID = 2
ENDPOINT_F_HOST = 1


def ip4(s: str) -> int:
    return int(ipaddress.IPv4Address(s))


def ip6(s: str) -> int:
    return int(ipaddress.IPv6Address(s))


def as_i32(a) -> np.ndarray:
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def v6_words(addrs) -> tuple:
    w = np.zeros((4, len(addrs)), np.int64)
    for i, a in enumerate(addrs):
        for j in range(4):
            w[j, i] = (int(a) >> (96 - 32 * j)) & 0xFFFFFFFF
    return tuple(as_i32(w[j]) for j in range(4))


class Clock:
    """A settable clock for CtMap: entries expire when it moves on."""

    def __init__(self, now: int = 1000) -> None:
        self.now = now

    def __call__(self) -> int:
        return self.now


def _policy(m, rng, idents, direction, n_extra, proxy_port):
    pol = m.PolicyMap()
    for ident in idents:
        roll = rng.random()
        if roll < 0.6:
            pol.allow(ident, rng.choice([8000, 8080, 65535]), PROTO_TCP, direction,
                      proxy_port=proxy_port if rng.random() < 0.4 else 0)
        elif roll < 0.75:
            pol.allow(ident, 0, 0, direction)  # L3-only allow
    for i in range(n_extra):
        pol.allow(5000 + i, 8000 + i % 7, PROTO_TCP, direction)
    pol.allow(0, 53, PROTO_UDP, direction)  # wildcard-identity rule
    pol.allow(0, 443, PROTO_TCP, direction, proxy_port=proxy_port + 1)
    return pol


def egress4_world(m, rng, clock, n_services=6, n_prefixes=24, n_policy=8, n_ct=40):
    """v4 egress maps: (ct, lb, ipc, pol, ct_keys) with ``ct_keys`` the
    live CT tuples."""
    lb = m.LbMap()
    for s in range(n_services):
        vip = ip4(f"172.16.0.{s + 1}")
        backends = [(ip4(f"10.9.{s}.{b + 1}"), rng.choice([8000, 8080, 65535]))
                    for b in range(rng.randrange(1, 4))]
        lb.upsert_service(vip, 80, backends, rev_nat_index=s + 1)
        if s % 3 == 0:  # a wildcard-port service on the same VIP
            lb.upsert_service(vip, 0, [(ip4(f"192.168.{s}.1"), 9090)], rev_nat_index=100 + s)
    lb.upsert_service(ip4("172.16.1.1"), 80, [], rev_nat_index=77)  # no backends
    ipc = m.IpcacheMap()
    for i in range(n_prefixes):
        ipc.upsert(f"10.{i % 10}.{i}.0/24", sec_label=256 + i)
    ipc.upsert("10.9.0.0/16", sec_label=600)
    ipc.upsert("10.9.1.2/32", sec_label=777)
    ipc.upsert("192.168.0.0/16", sec_label=3000)
    ipc.upsert("0.0.0.0/0", sec_label=9)  # /0: every address matches
    pol = _policy(m, rng, [256 + i for i in range(n_prefixes)] + [600, 777, 3000, 9],
                  DIR_EGRESS, n_policy, 15000)
    ct = m.CtMap(clock=clock)
    keys = []
    for i in range(n_ct):
        k = m.CtKey4(daddr=ip4(f"10.9.{i % n_services}.{i % 3 + 1}"),
                     saddr=ip4(f"200.0.0.{i % 250 + 1}"), dport=rng.choice([8000, 8080, 65535]),
                     sport=65535 - i, nexthdr=PROTO_TCP)
        ct.create(k)
        keys.append(k)
    clock.now -= 100  # these UDP entries are created 100 s back: 60 s lifetime, expired
    for i in range(4):
        ct.create(m.CtKey4(daddr=ip4(f"10.9.{i}.1"), saddr=ip4("200.0.0.1"), dport=53,
                           sport=30000 + i, nexthdr=PROTO_UDP))
    clock.now += 100
    return ct, lb, ipc, pol, keys


def egress4_packets(rng, f, ct_keys, n_services=6):
    cols = {k: np.zeros((f,), np.int64) for k in ("saddr", "daddr", "sport", "dport", "proto")}
    for i in range(f):
        roll = rng.random()
        if roll < 0.2 and ct_keys:  # established
            k = ct_keys[rng.randrange(len(ct_keys))]
            vals = (k.saddr, k.daddr, k.sport, k.dport, k.nexthdr)
        else:
            saddr = ip4(f"200.0.0.{rng.randrange(1, 251)}")
            if roll < 0.5:
                daddr = ip4(f"172.16.{rng.choice([0, 0, 0, 1])}.{rng.randrange(1, n_services + 2)}")
                dport = rng.choice([80, 80, 81, 0])
            elif roll < 0.85:
                daddr = ip4(f"10.{rng.randrange(10)}.{rng.randrange(30)}.{rng.randrange(1, 5)}")
                dport = rng.choice([8000, 8080, 443, 53, 65535, 0])
            else:
                daddr = ip4(f"{rng.choice([8, 192, 250])}.168.9.{rng.randrange(1, 9)}")
                dport = rng.choice([443, 8000])
            vals = (saddr, daddr, rng.randrange(1024, 65536), dport,
                    rng.choice([PROTO_TCP, PROTO_TCP, PROTO_UDP]))
            if vals[3] == 0:  # dport 0 needs proto 0 to reach an L3-only entry
                vals = (*vals[:4], 0)
        for key, v in zip(cols, vals):
            cols[key][i] = v
    return tuple(as_i32(cols[k]) for k in ("saddr", "daddr", "sport", "dport", "proto"))


def egress6_world(m, rng, clock, n_services=4, n_prefixes=12, n_ct=12):
    lb = m.LbMap()
    for s in range(n_services):
        backends = [(ip6(f"fd00:be::{s * 8 + b + 1:x}"), 8000 + b) for b in range(rng.randrange(1, 4))]
        lb.upsert_service6(ip6(f"fd00:aa::{s + 1:x}"), 80, backends, rev_nat_index=s + 1)
    lb.upsert_service6(ip6("fd00:aa::1"), 0, [(ip6("ff00::9"), 9090)], rev_nat_index=50)
    ipc = m.IpcacheMap()
    for i in range(n_prefixes):
        ipc.upsert(f"fd00:{i:x}::/64", sec_label=200 + i)
    ipc.upsert("fd00:be::/64", sec_label=600)
    ipc.upsert("fd00:3::7/128", sec_label=777)
    ipc.upsert("ff00::/8", sec_label=3000)
    pol = _policy(m, rng, [200 + i for i in range(n_prefixes)] + [600, 777, 3000], DIR_EGRESS, 4, 16000)
    ct = m.CtMap(clock=clock)
    keys = []
    for k in range(n_ct):
        key = m.CtKey6(daddr=ip6(f"fd00:be::{k % 5 + 1:x}"), saddr=ip6(f"fd00:1::{k + 5:x}"),
                       dport=8000 + k % 3, sport=42000 + k, nexthdr=PROTO_TCP)
        ct.create(key)
        keys.append(key)
    clock.now -= 100
    ct.create(m.CtKey6(daddr=ip6("fd00:be::1"), saddr=ip6("fd00:1::5"), dport=8000, sport=1,
                       nexthdr=PROTO_UDP))
    clock.now += 100
    return ct, lb, ipc, pol, keys


def egress6_packets(rng, f, ct_keys):
    """(saddr ints, daddr ints, saddr words, daddr words, sport, dport, proto)."""
    saddr, daddr = [], []
    sport = np.zeros((f,), np.int64)
    dport = np.zeros((f,), np.int64)
    proto = np.zeros((f,), np.int64)
    for i in range(f):
        roll = rng.random()
        if roll < 0.2 and ct_keys:
            k = ct_keys[rng.randrange(len(ct_keys))]
            saddr.append(k.saddr)
            daddr.append(k.daddr)
            sport[i], dport[i], proto[i] = k.sport, k.dport, k.nexthdr
            continue
        saddr.append(ip6(f"fd00:{rng.randrange(8):x}::{rng.randrange(1, 200):x}"))
        if roll < 0.5:
            daddr.append(ip6(f"fd00:aa::{rng.randrange(1, 6):x}"))
            dport[i] = rng.choice([80, 80, 8080])
        elif roll < 0.75:
            daddr.append(ip6(f"fd00:be::{rng.randrange(1, 30):x}"))
            dport[i] = rng.choice([8000, 53, 65535])
        elif roll < 0.85:
            daddr.append(ip6("fd00:3::7"))
            dport[i] = 8000
        else:
            daddr.append(ip6(rng.choice(["2001:db8::9", "ff00::1:2"])))
            dport[i] = 443
        sport[i] = rng.randrange(1024, 65536)
        proto[i] = PROTO_TCP if rng.random() < 0.8 else PROTO_UDP
    return (saddr, daddr, v6_words(saddr), v6_words(daddr), as_i32(sport), as_i32(dport),
            as_i32(proto))


def node_world(m, rng, clock, n_prefixes=16, n_endpoints=6, n_ct=8):
    """Node-ingress maps: (ipc, lxc, ct, pol)."""
    ipc = m.IpcacheMap()
    for i in range(n_prefixes):
        ipc.upsert(f"10.0.{i}.0/24", sec_label=100 + i)
    # Remote-node pod CIDRs reachable via the overlay; endpoints >= 2^31.
    ipc.upsert("10.2.0.0/24", sec_label=300, tunnel_endpoint=ip4("192.168.1.2"))
    ipc.upsert("10.2.1.0/24", sec_label=301, tunnel_endpoint=ip4("255.255.255.254"))
    ipc.upsert("10.3.0.0/24", sec_label=HOST_ID)  # a prefix that claims HOST_ID
    ipc.upsert("10.4.0.0/24", sec_label=0)  # an identity of 0 never overrides
    lxc = m.LxcMap()
    for e in range(n_endpoints):
        lxc.upsert(f"10.0.0.{e + 10}", 40 + e, m.EndpointInfo(ifindex=e + 2))
    lxc.upsert("10.0.0.1", 1, m.EndpointInfo(flags=ENDPOINT_F_HOST))
    pol = _policy(m, rng, [100, 101, 102, 300, WORLD_ID], DIR_INGRESS, 4, 14000)
    ct = m.CtMap(clock=clock)
    for k in range(n_ct):  # established inbound flows (forward orientation)
        ct.create(m.CtKey4(daddr=ip4(f"10.0.0.{k % n_endpoints + 10}"), saddr=ip4("10.0.1.5"),
                           dport=8080, sport=41000 + k, nexthdr=PROTO_TCP))
    for k in range(n_ct):  # egress-created entries: replies come back swapped
        ct.create(m.CtKey4(daddr=ip4("203.0.113.9"), saddr=ip4(f"10.0.0.{k % n_endpoints + 10}"),
                           dport=443, sport=50000 + k, nexthdr=PROTO_TCP))
    clock.now -= 100
    ct.create(m.CtKey4(daddr=ip4("10.0.0.10"), saddr=ip4("10.0.1.5"), dport=53, sport=5353,
                       nexthdr=PROTO_UDP))
    clock.now += 100
    return ipc, lxc, ct, pol


def node_packets(rng, f, n_endpoints=6):
    cols = {k: np.zeros((f,), np.int64) for k in
            ("saddr", "daddr", "sport", "dport", "proto", "src_id", "vni")}
    for i in range(f):
        roll = rng.random()
        if roll < 0.35:
            cols["saddr"][i] = ip4(f"10.0.{rng.randrange(16)}.{rng.randrange(2, 250)}")
        elif roll < 0.5:
            cols["saddr"][i] = ip4(f"10.{rng.choice([3, 4])}.0.{rng.randrange(1, 250)}")
        else:
            cols["saddr"][i] = ip4(f"203.0.{rng.randrange(113, 120)}.{rng.randrange(1, 250)}")
        droll = rng.random()
        if droll < 0.45:  # local endpoint, sometimes an established tuple
            cols["daddr"][i] = ip4(f"10.0.0.{rng.randrange(10, 10 + n_endpoints)}")
            cols["dport"][i] = rng.choice([8080, 53, 9000, 65535])
            cols["sport"][i] = rng.choice([41000, 41001, 443, 55555])
            pick = rng.random()
            if pick < 0.25:
                cols["saddr"][i] = ip4("10.0.1.5")
            elif pick < 0.4:  # a reply to an egress-created entry
                cols["saddr"][i] = ip4("203.0.113.9")
                cols["sport"][i] = 443
                cols["dport"][i] = 50000 + rng.randrange(10)
        elif droll < 0.55:
            cols["daddr"][i] = ip4("10.0.0.1")
            cols["dport"][i] = 22
            cols["sport"][i] = rng.randrange(1024, 65536)
        elif droll < 0.8:
            cols["daddr"][i] = ip4(f"10.2.{rng.randrange(2)}.{rng.randrange(1, 250)}")
            cols["dport"][i] = 8080
            cols["sport"][i] = rng.randrange(1024, 65536)
        else:
            cols["daddr"][i] = ip4("198.51.100.7")
            cols["dport"][i] = 443
            cols["sport"][i] = rng.randrange(1024, 65536)
        cols["proto"][i] = PROTO_TCP if rng.random() < 0.8 else PROTO_UDP
        cols["src_id"][i] = rng.choice([0, 0, HOST_ID, 4, 100, 255, 256, 5000, -7])
        cols["vni"][i] = rng.choice([100, 101, 300, WORLD_ID, 0])
    return {k: as_i32(v) for k, v in cols.items()}
