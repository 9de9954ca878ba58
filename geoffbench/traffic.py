"""The one traffic generator. A mix is a data file (``traffic/<name>.json``)
of parameters; this module turns it and ``--seed`` into requests.

Every seed gets the same set of sizes and the same set of gaps between
arrivals, in another order: each block of ``block`` consecutive requests
holds the ``block`` quantile midpoints of the length distribution and, in
an open loop, of the exponential gap distribution (Poisson arrivals), each
block in its own seeded order. The work and the offered load of a window are therefore
fixed by the mix, and the seed moves only where the long documents (and
the short gaps) fall.

Keys of a mix:
  loop          "open" (Poisson arrivals at a fixed rate) or "closed"
                (clients that send the next document when their last label
                is back)
  rate_per_s    open: the fixed offered rate
  clients       closed: the number of clients
  backlog_per_s closed: documents made per second of window (the archive)
  block         requests per block of quantiles
  text          lognormal token count: median, sigma, min, max
  object        what the store holds for a request: "tokens" (the document)
                or "patches" (the page's patch embeddings; the question's
                tokens travel in the payload)
  link          the document region's link to the GPU region: rtt_s and
                bandwidth_Bps (a GET costs rtt_s / 2 + bytes / bandwidth)
  check         sample: how many finished requests the reference checks
  warmup        concurrency: requests warmed at once at the longest length
"""
from __future__ import annotations

import hashlib
import math
import random
import statistics
from dataclasses import dataclass
from typing import Optional

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream, from the run's seed and the tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


@dataclass(frozen=True)
class Request:
    index: int
    text_len: int          # token ids (the document, or the page's question)
    patches: int           # patch embeddings in front of the text (0: none)
    due_s: Optional[float]  # open loop: offset from the window's start

    @property
    def tokens(self) -> int:
        """Prompt positions the model runs: patches and text."""
        return self.patches + self.text_len


def lognormal_grid(text: dict, n: int) -> list:
    """The n quantile midpoints of the clipped lognormal, as whole tokens."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        x = text["median"] * math.exp(text["sigma"] * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(text["max"], max(text["min"], round(x)))))
    return out


def gap_grid(rate: float, n: int) -> list:
    """The n quantile midpoints of the exponential gap, scaled so that
    their mean is exactly 1 / rate."""
    g = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    s = sum(g)
    return [x * n / (s * rate) for x in g]


def _blocks(grid: list, n_blocks: int, rng: random.Random) -> list:
    out = []
    for _ in range(n_blocks):
        b = list(grid)
        rng.shuffle(b)
        out.extend(b)
    return out


def schedule(mix: dict, seed: int, seconds: float, patches: int,
             rate: Optional[float] = None) -> list:
    """The window's requests. Open loop: every request due in
    ``[0, seconds)``, at ``rate`` (default the mix's). Closed loop: the
    backlog the clients draw from, in order."""
    b = mix["block"]
    lens_rng = random.Random(derive(seed, "lengths"))
    if mix["loop"] == "open":
        rate = mix["rate_per_s"] if rate is None else rate
        n_blocks = max(1, int(rate * seconds // b))
        lens = _blocks(lognormal_grid(mix["text"], b), n_blocks, lens_rng)
        gaps = _blocks(gap_grid(rate, b), n_blocks,
                       random.Random(derive(seed, "gaps")))
        due, out = 0.0, []
        for i, (n, g) in enumerate(zip(lens, gaps)):
            out.append(Request(i, n, patches, due))
            due += g
        return out
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r}: choose open or closed")
    n_blocks = max(1, math.ceil(mix["backlog_per_s"] * seconds / b))
    lens = _blocks(lognormal_grid(mix["text"], b), n_blocks, lens_rng)
    return [Request(i, n, patches, None) for i, n in enumerate(lens)]


def warmup_requests(mix: dict, patches: int) -> list:
    """Set-up's requests: ``warmup.concurrency`` at the longest length the
    mix sends, then one at its median, indices below 0 (content of their
    own)."""
    text = mix["text"]
    k = mix["warmup"]["concurrency"]
    longest = [Request(-1 - i, text["max"], patches, None) for i in range(k)]
    return longest + [Request(-1 - k, int(text["median"]), patches, None)]


def text_tokens(seed: int, req: Request, vocab: int) -> torch.Tensor:
    """Request ``req``'s token ids (int32, on the host)."""
    g = torch.Generator().manual_seed(derive(seed, "text", req.index))
    return torch.randint(0, vocab, (req.text_len,), generator=g, dtype=torch.int32)


def page_patches(seed: int, req: Request, d_model: int, device) -> torch.Tensor:
    """Request ``req``'s patch embeddings ((patches, d_model) bf16), drawn on
    ``device`` (an upstream encoder's output)."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "patches", req.index))
    return torch.randn((req.patches, d_model), generator=g, device=device,
                       dtype=torch.bfloat16)
