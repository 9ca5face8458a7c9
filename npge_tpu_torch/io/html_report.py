# mirrors npge_tpu/io/html_report.py
"""Self-contained HTML report — the qnpge GUI analog.

The reference ships a Qt GUI (``qnpge``: BlockSetWidget block table +
AlignmentView colored alignment browser over a per-genome block map,
SURVEY.md §2.5 ⚠[B]); per SURVEY §2.6 the GUI is out of scope for the
metric, so this module renders the same information into one
dependency-free HTML file:

  - summary line;
  - an SVG **genome map**: one track per sequence, segments colored by
    block type (s/r/h; unique blocks draw as thin neutral ticks — a
    second, non-color encoding), native hover tooltips, click-to-jump
    to the alignment view; sub-pixel fragments are culled (counted in
    the table, invisible at map scale anyway) so the map stays small at
    the 56 Mbp magnitude;
  - a **BSA rearrangements view** (the qnpge blockset-alignment pane):
    per-sequence stem-block order against the scaffold, minus-strand
    (inverted) entries highlighted;
  - a **sortable, filterable block table** (vanilla JS, no deps);
  - **lazy alignment views**: row texts ship as ONE JSON data island
    (1 byte/char instead of a ~30-byte span per char) and are rendered
    client-side the first time a block's <details> opens — the r3 report
    inlined every span eagerly and hit 5.5 MB on a 0.4 Mbp world.

Colors are the first three slots of the validated reference categorical
palette (documented all-pairs safe in light and dark modes), stepped for
dark mode; text wears text tokens, never series colors.
"""

from __future__ import annotations

import html

import numpy as np

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.blocks import Block, BlockSet
from npge_tpu_torch.model.naming import block_type
from npge_tpu_torch.model.stats import make_stat
from npge_tpu_torch.io.bs import fragment_id
from npge_tpu_torch.util import codes as C

# block type -> categorical slot (s=blue, r=orange, h=aqua; u = neutral).
# Light/dark values are the reference palette's documented steps.
_TYPE_SLOT = {"s": 1, "r": 2, "h": 3}

_CSS = """
body { font-family: system-ui, sans-serif; margin: 1.5em;
       color-scheme: light;
       --surface-1: #fcfcfb; --text-primary: #0b0b0b;
       --text-secondary: #52514e; --grid: #ddd;
       --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
       --neutral: #b9b8b3;
       background: var(--surface-1); color: var(--text-primary); }
@media (prefers-color-scheme: dark) {
  body { color-scheme: dark;
         --surface-1: #1a1a19; --text-primary: #ffffff;
         --text-secondary: #c3c2b7; --grid: #3a3a38;
         --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
         --neutral: #6b6a66; }
}
table { border-collapse: collapse; margin: 1em 0; }
td, th { border: 1px solid var(--grid); padding: 2px 8px; font-size: 13px; }
th { background: color-mix(in srgb, var(--text-primary) 6%, transparent);
     cursor: pointer; user-select: none; }
.aln { font-family: ui-monospace, monospace; font-size: 12px;
       white-space: pre; line-height: 1.1; overflow-x: auto;
       border: 1px solid var(--grid); padding: 4px; }
.A { background:#c8e6c9; color:#0b0b0b } .C { background:#bbdefb; color:#0b0b0b }
.G { background:#fff9c4; color:#0b0b0b } .T { background:#ffcdd2; color:#0b0b0b }
.N { background:#eeeeee; color:#0b0b0b } .gap { color:var(--text-secondary) }
.mis { outline: 1px solid #d32f2f; }
h3 { margin-bottom: 0.2em; }
.meta { color: var(--text-secondary); font-size: 13px; }
.map text { font-size: 11px; fill: var(--text-secondary);
            font-family: system-ui, sans-serif; }
.map rect.t1 { fill: var(--series-1); } .map rect.t2 { fill: var(--series-2); }
.map rect.t3 { fill: var(--series-3); } .map rect.tu { fill: var(--neutral); }
.map rect:hover { stroke: var(--text-primary); stroke-width: 1; }
.legend { font-size: 13px; color: var(--text-secondary); margin: 0.4em 0; }
.legend span.swatch { display: inline-block; width: 12px; height: 12px;
       border-radius: 3px; vertical-align: -2px; margin: 0 4px 0 12px; }
#filter { margin: 0.4em 0; padding: 2px 6px; }
details.alnblock { margin: 0.6em 0; }
details.alnblock summary { cursor: pointer; font-weight: 600; }
.bsawrap { overflow-x: auto; max-width: 100%; }
.bsa td, .bsa th { font-size: 11px; padding: 1px 4px; white-space: nowrap; }
.bsa td.inv, span.inv { background: color-mix(in srgb, var(--series-2) 30%,
                        transparent); }
"""

_JS = """
let _alnData = null;
function alnData() {
  if (_alnData === null)
    _alnData = JSON.parse(document.getElementById('alndata').textContent);
  return _alnData;
}
function renderAln(det) {
  if (det.dataset.done) return;
  det.dataset.done = 1;
  const data = alnData()[det.dataset.key];
  if (!data) return;
  const rows = data.rows, ids = data.ids, F = rows.length;
  const n = F ? rows[0].length : 0;
  // column good = gapless and identical across rows
  const good = new Uint8Array(n);
  for (let c = 0; c < n; c++) {
    let ch = rows[0][c], ok = ch != '-';
    for (let r = 1; ok && r < F; r++) ok = rows[r][c] == ch && ch != '-';
    good[c] = ok ? 1 : 0;
  }
  const w = Math.max(...ids.map(s => s.length));
  const esc = s => s.replace(/&/g, '&amp;').replace(/</g, '&lt;');
  const lines = [];
  for (let r = 0; r < F; r++) {
    const parts = [esc(ids[r].padEnd(w)) + '  '];
    for (let c = 0; c < n; c++) {
      const ch = rows[r][c];
      let cls = ch == '-' ? 'gap' : ('ACGT'.includes(ch) ? ch : 'N');
      if (ch != '-' && !good[c]) cls += ' mis';
      parts.push('<span class="' + cls + '">' + ch + '</span>');
    }
    lines.push(parts.join(''));
  }
  det.querySelector('.aln').innerHTML = lines.join('\\n');
}
function sortTable(col) {
  const tb = document.getElementById('blocks');
  const rows = Array.from(tb.tBodies[0].rows);
  const dir = tb.dataset.sc == col ? -(+tb.dataset.sd || 1) : 1;
  tb.dataset.sc = col; tb.dataset.sd = dir;
  rows.sort((a, b) => {
    const x = a.cells[col].dataset.v ?? a.cells[col].textContent;
    const y = b.cells[col].dataset.v ?? b.cells[col].textContent;
    const nx = parseFloat(x), ny = parseFloat(y);
    if (!isNaN(nx) && !isNaN(ny)) return dir * (nx - ny);
    return dir * x.localeCompare(y);
  });
  rows.forEach(r => tb.tBodies[0].appendChild(r));
}
function filterTable() {
  const q = document.getElementById('filter').value.toLowerCase();
  for (const r of document.getElementById('blocks').tBodies[0].rows)
    r.style.display = r.textContent.toLowerCase().includes(q) ? '' : 'none';
}
"""


def _block_view(b: Block, bs: BlockSet, max_cols: int, data: dict) -> str:
    """Lazy alignment view: the <details> shell plus a JSON record in
    ``data``; rows render client-side on first open (module docstring)."""
    rows = b.rows(bs.arena)
    truncated = ""
    if rows.shape[1] > max_cols:
        rows = rows[:, :max_cols]
        truncated = f" (first {max_cols} of {b.n_cols} columns)"
    key = b.name or f"?{len(data)}"
    data[key] = {
        "ids": [
            fragment_id(bs.arena, *b.frags.row(i)) for i in range(b.n_frags)
        ],
        "rows": [C.decode(rows[i]) for i in range(b.n_frags)],
    }
    return (
        f'<details class="alnblock" data-key="{html.escape(key)}" '
        f'ontoggle="renderAln(this)">'
        f'<summary><span id="{html.escape(b.name or "")}"></span>'
        f"{html.escape(b.name or '?')} — {b.n_frags} fragments x "
        f"{b.n_cols} columns{truncated}</summary>"
        f"<div class='aln'></div></details>"
    )


def _bsa_view(bs: BlockSet, max_cols: int = 300) -> str:
    """BSA rearrangements pane: per-sequence stem-block order against the
    scaffold (algo/bsa.find_bsa); minus-strand entries (inversions relative
    to the scaffold) are highlighted, '.' marks a scaffold block missing
    from that row at its scaffold position."""
    import sys

    from npge_tpu_torch.algo.bsa import find_bsa

    try:
        bsa = find_bsa(bs)
    except Exception as e:  # degenerate blockset: report it, don't hide it
        print(f"report: BSA pane skipped ({e!r})", file=sys.stderr)
        return ""
    if not bsa.columns:
        return ""
    cols = bsa.columns[:max_cols]
    note = (
        f" (first {max_cols} of {len(bsa.columns)} scaffold columns)"
        if len(bsa.columns) > max_cols
        else ""
    )
    parts = [
        f"<h2>Rearrangements (BSA)</h2><div class='meta'>stem-block order "
        f"per sequence; <span class='inv'>inverted</span> = minus strand "
        f"relative to the scaffold{note}</div>",
        "<div class='bsawrap'><table class='bsa'><thead><tr><th>sequence</th>",
    ]
    for c in cols:
        parts.append(f"<th>{html.escape(c)}</th>")
    parts.append("</tr></thead><tbody>")
    for name, row in zip(bsa.seq_names, bsa.table):
        parts.append(f"<tr><td>{html.escape(name)}</td>")
        for v in row[: len(cols)]:
            cls = " class='inv'" if v.startswith("-") else ""
            parts.append(f"<td{cls}>{html.escape(v)}</td>")
        parts.append("</tr>")
    parts.append("</tbody></table></div>")
    return "".join(parts)


def _genome_map(bs: BlockSet, linked: set[str]) -> str:
    """One SVG track per sequence; fragments colored by block type.

    Unique (u) blocks render as thin neutral ticks — type is encoded by
    color AND mark height, so the map survives CVD/print. Hover = native
    <title> tooltip; click jumps to the block's alignment view when one
    is rendered."""
    arena = bs.arena
    genome_of_seq = arena.genome_id_of_seq()
    n_genomes = len(arena.genomes())
    W = 1000
    track_h, gap, label_w = 14, 7, 0
    n = arena.n_seqs
    H = n * (track_h + gap) + 18
    maxlen = max(arena.seq_len(i) for i in range(n)) or 1
    parts = [
        f'<svg class="map" viewBox="0 0 {W} {H}" width="100%" '
        f'style="max-width:1100px" role="img" '
        f'aria-label="genome block map">'
    ]
    for i in range(n):
        y = 14 + i * (track_h + gap)
        name = arena.names[i].split("&")[0]
        parts.append(f'<text x="0" y="{y - 2}">{html.escape(name)}</text>')
        sl = arena.seq_len(i)
        parts.append(
            f'<rect x="0" y="{y + track_h // 2 - 1}" '
            f'width="{W * sl / maxlen:.1f}" height="2" class="tu"/>'
        )
    culled = 0
    for b in bs.blocks:
        t = block_type(b, genome_of_seq, n_genomes)
        slot = _TYPE_SLOT.get(t)
        cls = f"t{slot}" if slot else "tu"
        for i in range(b.n_frags):
            s, st, ln, o = b.frags.row(i)
            if W * ln / maxlen < 0.4:
                # sub-pixel at map scale: invisible anyway; culling keeps
                # the SVG bounded at Brucella magnitude (~42k fragments)
                culled += 1
                continue
            y = 14 + s * (track_h + gap)
            x0 = W * st / maxlen
            wd = max(W * ln / maxlen, 1.0)
            if slot is None:  # unique: thin neutral tick (second encoding)
                y0, h = y + track_h // 4, track_h // 2
            else:
                y0, h = y, track_h
            tip = html.escape(
                f"{b.name or '?'} [{t}] {ln} bp @ {st} "
                f"{'+' if o == 1 else '-'}"
            )
            rect = (
                f'<rect x="{x0:.1f}" y="{y0}" width="{wd:.1f}" '
                f'height="{h}" rx="1" class="{cls}">'
                f"<title>{tip}</title></rect>"
            )
            if b.name and b.name in linked:
                rect = f'<a href="#{html.escape(b.name)}">{rect}</a>'
            parts.append(rect)
    parts.append("</svg>")
    legend = (
        '<div class="legend">block type:'
        '<span class="swatch" style="background:var(--series-1)"></span>s '
        "(one fragment per genome)"
        '<span class="swatch" style="background:var(--series-2)"></span>r '
        "(repeat)"
        '<span class="swatch" style="background:var(--series-3)"></span>h '
        "(subset of genomes)"
        '<span class="swatch" style="background:var(--neutral)"></span>u '
        "(unique, thin)</div>"
    )
    if culled:
        legend += (
            f"<div class='legend'>{culled} sub-pixel fragments not drawn "
            f"(all blocks remain listed in the table)</div>"
        )
    return "<h2>Genome map</h2>" + legend + "".join(parts)


def write_report(
    bs: BlockSet,
    path: str,
    cfg: Config | None = None,
    max_blocks: int = 50,
    max_cols: int = 2000,
) -> None:
    from npge_tpu_torch.algo.reports import blockset_summary

    s = blockset_summary(bs, cfg)
    genome_of_seq = bs.arena.genome_id_of_seq()
    n_genomes = len(bs.arena.genomes())
    parts = [
        "<!doctype html><meta charset='utf-8'><title>npge-tpu report</title>",
        f"<style>{_CSS}</style><script>{_JS}</script>",
        "<h1>npge-tpu pangenome report</h1>",
        f"<div class='meta'>genomes: {s['genomes']} | sequences: "
        f"{s['sequences']} | total {s['total_length']} bp | blocks: "
        f"{s['blocks']} | shared: {100 * s['shared_fraction']:.2f}% | "
        f"hash: {s['blockset_hash']}</div>",
    ]
    order = sorted(
        range(len(bs.blocks)),
        key=lambda i: (-bs.blocks[i].n_frags * bs.blocks[i].n_cols, i),
    )
    views, linked = [], set()
    aln_data: dict = {}
    shown = 0
    rows_html = []
    for i in order:
        b = bs.blocks[i]
        st = make_stat(b, bs.arena)
        idn = st.ident_nogap / max(st.total, 1)
        t = block_type(b, genome_of_seq, n_genomes)
        link = ""
        if b.n_frags >= 2 and shown < max_blocks:
            link = f"<a href='#{html.escape(b.name or '')}'>view</a>"
            views.append(_block_view(b, bs, max_cols, aln_data))
            if b.name:  # unnamed blocks (pre-naming stages) get no anchor
                linked.add(b.name)
            shown += 1
        rows_html.append(
            f"<tr><td>{html.escape(b.name or '?')}</td><td>{t}</td>"
            f"<td data-v='{b.n_frags}'>{b.n_frags}</td>"
            f"<td data-v='{b.n_cols}'>{b.n_cols}</td>"
            f"<td data-v='{idn:.4f}'>{idn:.4f}</td><td>{link}</td></tr>"
        )
    parts.append(_genome_map(bs, linked))
    parts.append(_bsa_view(bs))
    parts.append(
        "<h2>Blocks</h2>"
        "<input id='filter' placeholder='filter blocks…' "
        "oninput='filterTable()'>"
        "<table id='blocks'><thead><tr>"
        "<th onclick='sortTable(0)'>name</th>"
        "<th onclick='sortTable(1)'>type</th>"
        "<th onclick='sortTable(2)'>fragments</th>"
        "<th onclick='sortTable(3)'>columns</th>"
        "<th onclick='sortTable(4)'>identity</th>"
        "<th>view</th></tr></thead><tbody>"
    )
    parts.extend(rows_html)
    parts.append(
        f"</tbody></table><h2>Alignments</h2>"
        f"<div class='meta'>{shown} largest multi-fragment blocks; "
        f"open a block to render its alignment</div>"
    )
    parts.extend(views)
    import json

    payload = json.dumps(aln_data, separators=(",", ":"))
    parts.append(
        '<script type="application/json" id="alndata">'
        + payload.replace("</", "<\\/")
        + "</script>"
    )
    with open(path, "w") as fh:
        fh.write("\n".join(parts))
