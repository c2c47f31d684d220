"""HTML retrieval-ranking pages (counterpart of tvts_tpu/utils/visualizer.py;
reference v2/utils/visualizer.py `RetrievalVis` and v2/utils/html.py): per
validation epoch, a page with each text query, the top-k retrieved videos
and the rank of its ground truth, from plain string templates.
"""

from __future__ import annotations

import html
import os

import numpy as np

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
.query {{ border: 1px solid #ccc; margin: 1em 0; padding: 1em; }}
.hit {{ display: inline-block; margin: 0.4em; text-align: center; }}
.gt {{ border: 3px solid #2a2; }}
video {{ max-width: 220px; }}
.rank {{ color: #666; font-size: 0.9em; }}
</style></head><body><h1>{title}</h1>{body}</body></html>
"""


class RetrievalVis:
    def __init__(self, exp_name: str, web_dir: str, src_video_dir: str = "",
                 vis_vid_freq: int = 1, num_samples: int = 20):
        self.exp_name = exp_name
        self.web_dir = web_dir
        self.src_video_dir = src_video_dir
        self.vis_vid_freq = vis_vid_freq
        self.num_samples = num_samples
        os.makedirs(web_dir, exist_ok=True)

    def visualize_ranking(self, sims: np.ndarray, epoch: int, meta: dict,
                          nested_metrics: dict | None = None, topk: int = 5):
        """sims: [num_queries, num_vids]; meta: {'paths': [...], 'raw_captions': [...]}."""
        if self.vis_vid_freq <= 0 or epoch % self.vis_vid_freq != 0:
            return None
        order = np.argsort(-sims, axis=1)
        paths = list(meta.get("paths", []))
        caps = list(meta.get("raw_captions", []))
        sections = []
        n = min(self.num_samples, sims.shape[0])
        for qi in range(n):
            cap = html.escape(str(caps[qi]) if qi < len(caps) else f"query {qi}")
            gt = qi * sims.shape[1] // sims.shape[0]
            rank = int(np.where(order[qi] == gt)[0][0]) if gt < sims.shape[1] else -1
            hits = []
            for r, vi in enumerate(order[qi][:topk]):
                p = html.escape(str(paths[vi]) if vi < len(paths) else str(vi))
                cls = "hit gt" if vi == gt else "hit"
                src = os.path.join(self.src_video_dir, p) if self.src_video_dir else p
                hits.append(
                    f'<div class="{cls}"><video src="{src}" controls muted></video>'
                    f'<div class="rank">#{r + 1} sim={sims[qi, vi]:.3f}</div></div>')
            sections.append(
                f'<div class="query"><b>{cap}</b> '
                f'<span class="rank">(GT rank: {rank + 1})</span><br>'
                + "".join(hits) + "</div>")
        title = f"{self.exp_name} — epoch {epoch}"
        out_path = os.path.join(self.web_dir, f"ranking_ep{epoch}.html")
        with open(out_path, "w") as f:
            f.write(_PAGE.format(title=html.escape(title), body="".join(sections)))
        return out_path
