"""Dataset prep: CSV-driven video download and archive extraction.

Counterpart of `videopainter_tpu/data_utils/download.py` (reference
data_utils/VPData_download.py: CSV rows with url and path columns, a
streamed download; data_utils/unzip_folder.py), on the standard library's
`csv` and `urllib.request`, so neither pandas nor requests is needed.

    python -m videopainter_tpu_torch.data_utils.download download \\
        --meta_file_path meta.csv --out_dir videos/
    python -m videopainter_tpu_torch.data_utils.download unzip --src_dir zips/ --dst_dir out/
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import urllib.request
import zipfile

_CHUNK = 1 << 20
_TIMEOUT_S = 60.0   # per connection attempt and read


def download_videos(meta_file_path: str, out_dir: str, url_col: str = "url",
                    path_col: str = "path", overwrite: bool = False) -> int:
    """Fetch each row's `url_col` to out_dir/`path_col`, skipping files that
    exist unless `overwrite`; a partial download is never left under the
    final name. Returns the number of files fetched."""
    with open(meta_file_path, newline="") as f:
        rows = list(csv.DictReader(f))
    n = 0
    for row in rows:
        dst = os.path.join(out_dir, str(row[path_col]))
        if os.path.exists(dst) and not overwrite:
            continue
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        tmp = dst + ".part"
        try:
            with urllib.request.urlopen(str(row[url_col]), timeout=_TIMEOUT_S) as r, \
                    open(tmp, "wb") as out:
                shutil.copyfileobj(r, out, _CHUNK)
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        n += 1
    return n


def unzip_folder(src_dir: str, dst_dir: str) -> int:
    """Extract every src_dir/<name>.zip into dst_dir/<name>/; returns the count."""
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.endswith(".zip"):
            continue
        with zipfile.ZipFile(os.path.join(src_dir, name)) as z:
            z.extractall(os.path.join(dst_dir, name[:-4]))
        n += 1
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download")
    d.add_argument("--meta_file_path", required=True)
    d.add_argument("--out_dir", required=True)
    u = sub.add_parser("unzip")
    u.add_argument("--src_dir", required=True)
    u.add_argument("--dst_dir", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "download":
        print(download_videos(args.meta_file_path, args.out_dir), "files")
    else:
        print(unzip_folder(args.src_dir, args.dst_dir), "archives")


if __name__ == "__main__":
    main()
