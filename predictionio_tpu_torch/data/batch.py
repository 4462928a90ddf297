"""Columnar event batches and the integer-indexed triples training reads.

Counterpart of ``predictionio_tpu/data/batch.py``: :class:`EventBatch`
(``from_events``, ``interactions``), :class:`Interactions` (``subset``,
``drop_items``) and :func:`merge_interactions`, in numpy only. The id maps
are the port's :class:`~predictionio_tpu_torch.data.bimap.BiMap`, whose
bulk paths factorize with numpy where the JAX package uses pandas, with the
same first-seen order. :func:`interactions_from_arrays` carries triples and
id lists across from anywhere else (the JAX package's ``Interactions`` in
the tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event


@dataclass
class EventBatch:
    """A set of events in structure-of-arrays form."""

    event: np.ndarray  # object (str)
    entity_type: np.ndarray  # object (str)
    entity_id: np.ndarray  # object (str)
    target_entity_type: np.ndarray  # object (str | None)
    target_entity_id: np.ndarray  # object (str | None)
    event_time: np.ndarray  # float64 epoch seconds
    properties: list  # row-aligned property dicts

    @staticmethod
    def from_events(events: Iterable[Event]) -> "EventBatch":
        evs = list(events)
        n = len(evs)

        def col(f: Callable[[Event], object]) -> np.ndarray:
            a = np.empty(n, dtype=object)
            for i, e in enumerate(evs):
                a[i] = f(e)
            return a

        return EventBatch(
            event=col(lambda e: e.event),
            entity_type=col(lambda e: e.entity_type),
            entity_id=col(lambda e: e.entity_id),
            target_entity_type=col(lambda e: e.target_entity_type),
            target_entity_id=col(lambda e: e.target_entity_id),
            event_time=np.array(
                [e.event_time.timestamp() for e in evs], dtype=np.float64
            ),
            properties=[e.properties.to_dict() for e in evs],
        )

    def __len__(self) -> int:
        return len(self.event)

    def entity_bimap(self) -> BiMap[str, int]:
        return BiMap.string_int(self.entity_id)

    def target_bimap(self) -> BiMap[str, int]:
        has = np.fromiter(
            (t is not None for t in self.target_entity_id), bool, len(self)
        )
        return BiMap.string_int(self.target_entity_id[has])

    def property_column(self, key: str, default: float = np.nan) -> np.ndarray:
        """One numeric property across all rows as float64."""
        return np.array(
            [float(p.get(key, default)) for p in self.properties], dtype=np.float64
        )

    def interactions(
        self,
        user_map: Optional[BiMap[str, int]] = None,
        item_map: Optional[BiMap[str, int]] = None,
        rating_key: Optional[str] = None,
        default_rating: float = 1.0,
    ) -> "Interactions":
        """Convert (entity → target) events into integer-indexed triples."""
        if user_map is None:
            user_map = self.entity_bimap()
        if item_map is None:
            item_map = self.target_bimap()
        users = user_map.to_index_array(self.entity_id)
        items = item_map.to_index_array(
            ["" if t is None else t for t in self.target_entity_id]
        )
        if rating_key is None:
            ratings = np.full(len(self), default_rating, dtype=np.float32)
        else:
            ratings = self.property_column(rating_key, default_rating).astype(np.float32)
        ok = (users >= 0) & (items >= 0)
        return Interactions(
            user=users[ok].astype(np.int32),
            item=items[ok].astype(np.int32),
            rating=ratings[ok],
            t=self.event_time[ok],
            user_map=user_map,
            item_map=item_map,
        )


def merge_interactions(parts: "Sequence[Interactions]") -> "Interactions":
    """Concatenate Interactions with differing id maps into shared maps
    (first-seen order across the parts, in part order)."""
    parts = [p for p in parts if len(p)]
    if not parts:
        raise ValueError("nothing to merge")
    if len(parts) == 1:
        return parts[0]
    user_map = BiMap.string_int(
        np.concatenate([np.array(list(p.user_map.keys()), object) for p in parts])
    )
    item_map = BiMap.string_int(
        np.concatenate([np.array(list(p.item_map.keys()), object) for p in parts])
    )
    users, items, ratings, ts = [], [], [], []
    for p in parts:
        u_remap = user_map.to_index_array(list(p.user_map.keys()))
        i_remap = item_map.to_index_array(list(p.item_map.keys()))
        users.append(u_remap[p.user].astype(np.int32))
        items.append(i_remap[p.item].astype(np.int32))
        ratings.append(p.rating)
        ts.append(p.t)
    return Interactions(
        user=np.concatenate(users),
        item=np.concatenate(items),
        rating=np.concatenate(ratings),
        t=np.concatenate(ts),
        user_map=user_map,
        item_map=item_map,
    )


@dataclass
class Interactions:
    """Integer-indexed (user, item, rating, time) triples + their id tables."""

    user: np.ndarray  # int32
    item: np.ndarray  # int32
    rating: np.ndarray  # float32
    t: np.ndarray  # float64
    user_map: BiMap[str, int] = field(repr=False, default=None)
    item_map: BiMap[str, int] = field(repr=False, default=None)

    def __len__(self) -> int:
        return len(self.user)

    @property
    def n_users(self) -> int:
        return len(self.user_map) if self.user_map is not None else int(self.user.max()) + 1

    @property
    def n_items(self) -> int:
        return len(self.item_map) if self.item_map is not None else int(self.item.max()) + 1

    def subset(self, mask: np.ndarray) -> "Interactions":
        """Row-select by boolean mask or index array; id maps carry over."""
        return Interactions(
            user=self.user[mask],
            item=self.item[mask],
            rating=self.rating[mask],
            t=self.t[mask],
            user_map=self.user_map,
            item_map=self.item_map,
        )

    def drop_items(self, item_indices: np.ndarray) -> "Interactions":
        """Remove the given items' rows AND compact both id spaces: dropped
        items leave ``item_map``, and users left with no rows leave
        ``user_map``, so a model trained on the result cannot score them."""
        if self.item_map is None:
            raise ValueError("drop_items requires an item_map")
        n = len(self.item_map)
        keep_item = np.ones(n, bool)
        idx = np.asarray(item_indices, dtype=np.int64)
        keep_item[idx[(idx >= 0) & (idx < n)]] = False
        if keep_item.all():
            return self
        row_keep = keep_item[self.item]

        def _compact(mask: np.ndarray, bimap: BiMap):
            new_of_old = np.cumsum(mask) - 1
            inv = bimap.inverse
            new_map = BiMap(
                {inv[o]: int(new_of_old[o]) for o in range(len(mask)) if mask[o]}
            )
            return new_of_old, new_map

        item_of_old, new_item_map = _compact(keep_item, self.item_map)
        if self.user_map is None:
            return Interactions(
                user=self.user[row_keep],
                item=item_of_old[self.item[row_keep]].astype(self.item.dtype),
                rating=self.rating[row_keep],
                t=self.t[row_keep],
                user_map=None,
                item_map=new_item_map,
            )
        keep_user = np.zeros(len(self.user_map), bool)
        keep_user[self.user[row_keep]] = True
        user_of_old, new_user_map = _compact(keep_user, self.user_map)
        return Interactions(
            user=user_of_old[self.user[row_keep]].astype(self.user.dtype),
            item=item_of_old[self.item[row_keep]].astype(self.item.dtype),
            rating=self.rating[row_keep],
            t=self.t[row_keep],
            user_map=new_user_map,
            item_map=new_item_map,
        )


def interactions_from_arrays(
    user, item, rating, t, user_ids, item_ids
) -> Interactions:
    """Build the port's :class:`Interactions` from plain arrays.

    ``user_ids``/``item_ids`` list the external ids in index order (the JAX
    package's ``user_map.inverse[i]`` for ``i`` in ``range(n)``).
    """
    user_ids, item_ids = list(user_ids), list(item_ids)
    return Interactions(
        user=np.asarray(user, np.int32),
        item=np.asarray(item, np.int32),
        rating=np.asarray(rating, np.float32),
        t=np.asarray(t, np.float64),
        user_map=BiMap({u: i for i, u in enumerate(user_ids)}),
        item_map=BiMap({it: i for i, it in enumerate(item_ids)}),
    )
