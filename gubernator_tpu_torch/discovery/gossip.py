"""Gossip membership: the memberlist-equivalent discovery pool.

The reference rides hashicorp/memberlist (SWIM gossip over UDP/TCP,
``memberlist.go``).  That exact wire protocol isn't reproducible without
the library, so this is a self-contained **push-pull gossip** with the
same observable contract: nodes join via ``known_nodes``, carry their
``PeerInfo`` as node metadata (memberlist.go:126-151), learn the full
membership transitively, detect dead peers via failed probes, and emit
``on_update`` on every membership change.

Protocol: JSON-over-TCP.  Each round (1s) a node picks a random peer and
exchanges full state — a map ``addr → {info, incarnation, alive}``.  Entries
merge by highest incarnation; a node always re-asserts itself with a higher
incarnation if someone claims it dead (SWIM refutation).  A peer unreachable
for ``suspect_after`` consecutive probes is marked dead and pruned after it
gossips around.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator.gossip")


class MemberlistPool:
    def __init__(
        self,
        bind_address: str,
        known_nodes: Sequence[str],
        info: PeerInfo,
        on_update: Callable[[List[PeerInfo]], None],
        gossip_interval: float = 1.0,
        suspect_after: int = 3,
    ):
        if not bind_address:
            raise ValueError(
                "GUBER_MEMBERLIST_ADDRESS is required for member-list discovery"
            )
        self.bind_address = bind_address
        self.known_nodes = [n for n in known_nodes if n and n != bind_address]
        self.info = info
        self.on_update = on_update
        self.gossip_interval = gossip_interval
        self.suspect_after = suspect_after
        # addr (gossip address) → member record
        self._members: Dict[str, dict] = {
            bind_address: {
                "info": self._info_dict(info),
                "incarnation": int(time.time() * 1000),
                "alive": True,
            }
        }
        self._fails: Dict[str, int] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._task: Optional[asyncio.Task] = None
        self._last_emitted: Optional[List[PeerInfo]] = None

    @staticmethod
    def _info_dict(info: PeerInfo) -> dict:
        return {
            "grpc_address": info.grpc_address,
            "http_address": info.http_address,
            "datacenter": info.datacenter,
        }

    # ------------------------------------------------------------------
    # State merge
    # ------------------------------------------------------------------
    def _merge(self, remote: Dict[str, dict]) -> None:
        changed = False
        for addr, rec in remote.items():
            if addr == self.bind_address:
                # Refute any claim that we are dead (SWIM refutation).
                if not rec.get("alive", True):
                    mine = self._members[addr]
                    if rec.get("incarnation", 0) >= mine["incarnation"]:
                        mine["incarnation"] = rec["incarnation"] + 1
                        changed = True
                continue
            mine = self._members.get(addr)
            if mine is None or rec.get("incarnation", 0) > mine["incarnation"]:
                self._members[addr] = dict(rec)
                changed = True
            elif (
                rec.get("incarnation", 0) == mine["incarnation"]
                and not rec.get("alive", True)
                and mine["alive"]
            ):
                mine["alive"] = False  # dead beats alive at equal incarnation
                changed = True
        if changed:
            self._emit()

    def _emit(self) -> None:
        peers = sorted(
            (
                PeerInfo(**rec["info"])
                for rec in self._members.values()
                if rec.get("alive", True)
            ),
            key=lambda p: p.grpc_address,
        )
        if peers != self._last_emitted:
            self._last_emitted = peers
            self.on_update(list(peers))

    # ------------------------------------------------------------------
    # Wire
    # ------------------------------------------------------------------
    async def _handle(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), 5.0)
            remote = json.loads(line)
            self._merge(remote.get("members", {}))
            writer.write(
                (json.dumps({"members": self._members}) + "\n").encode()
            )
            await writer.drain()
        except (asyncio.TimeoutError, OSError, ValueError):
            pass
        finally:
            writer.close()

    async def _push_pull(self, addr: str) -> bool:
        host, _, port = addr.rpartition(":")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), 2.0
            )
            writer.write(
                (json.dumps({"members": self._members}) + "\n").encode()
            )
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), 5.0)
            self._merge(json.loads(line).get("members", {}))
            writer.close()
            return True
        except (OSError, ValueError, asyncio.TimeoutError):
            return False

    async def _gossip_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            candidates = [
                a
                for a, rec in self._members.items()
                if a != self.bind_address and rec.get("alive", True)
            ]
            # Keep trying seeds until we've met someone.
            if not candidates and self.known_nodes:
                candidates = list(self.known_nodes)
            if not candidates:
                continue
            addr = random.choice(candidates)
            ok = await self._push_pull(addr)
            if ok:
                self._fails.pop(addr, None)
            else:
                n = self._fails.get(addr, 0) + 1
                self._fails[addr] = n
                rec = self._members.get(addr)
                if rec is not None and rec["alive"] and n >= self.suspect_after:
                    rec["alive"] = False
                    rec["incarnation"] = rec.get("incarnation", 0)
                    log.info("gossip: marking %s dead after %d failed probes", addr, n)
                    self._emit()

    # ------------------------------------------------------------------
    async def start(self) -> None:
        host, _, port = self.bind_address.rpartition(":")
        self._server = await asyncio.start_server(
            self._handle, host or "0.0.0.0", int(port)
        )
        # Initial join (memberlist.go:126-151): push-pull every seed once.
        for seed in self.known_nodes:
            await self._push_pull(seed)
        self._task = asyncio.create_task(self._gossip_loop(), name="gossip")
        self._emit()

    async def close(self) -> None:
        """Leave: mark ourselves dead and gossip it once."""
        me = self._members[self.bind_address]
        me["alive"] = False
        me["incarnation"] += 1
        for addr, rec in list(self._members.items()):
            if addr != self.bind_address and rec.get("alive", True):
                await self._push_pull(addr)
                break
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
