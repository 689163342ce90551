"""Asset fetcher: everything the real-data path needs, one command (a
carried copy of ``scripts/prepare_assets.py``, framework-free: urllib and
tarfile; a test holds it equal to the original).

The reference's ``prepare/*.sh`` fetcher family (download_smpl_model.sh,
prepare_clip.sh, download_t2m_evaluators.sh,
download_pretrained_models.sh, download_action_datasets.sh,
download_action_recognition_models.sh) as a single Python CLI that degrades
gracefully offline: every target knows its source, destination, and
expected post-extract layout; anything that cannot be fetched is reported
with manual instructions instead of crashing. Paths are relative to the
repository root.

    python -m mld_tpu_torch.scripts.prepare_assets --all    # everything
    python -m mld_tpu_torch.scripts.prepare_assets clip t2m # some targets
    python -m mld_tpu_torch.scripts.prepare_assets --verify # readiness only

After a successful run, ``python -m mld_tpu_torch.scripts.parity_drill`` is
the one command between this machine and the released-checkpoint parity
number. No torch and no device: the fetch runs on the host.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tarfile
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _say(msg):
    print(f"[prepare] {msg}")


def _have_network(timeout=5) -> bool:
    try:
        urllib.request.urlopen("https://huggingface.co", timeout=timeout)
        return True
    except Exception:
        return False


def _download(url: str, dest: str) -> bool:
    """urllib download with a Google-Drive confirm-token retry."""
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "mld-tpu"})
        with urllib.request.urlopen(req, timeout=60) as r, \
                open(dest, "wb") as f:
            # Drive interstitial pages are HTML; archives are binary
            head = r.read(1024)
            if b"<html" in head[:200].lower() and "drive.google" in url:
                body = head + r.read()
                import re
                m = re.search(rb'confirm=([0-9A-Za-z_-]+)', body)
                if not m:
                    return False
                return _download(url + "&confirm=" +
                                 m.group(1).decode(), dest)
            f.write(head)
            shutil.copyfileobj(r, f)
        return True
    except Exception as e:  # noqa: BLE001 - report, don't crash
        _say(f"  download failed: {e}")
        return False


def _extract(archive: str, into: str) -> bool:
    os.makedirs(into, exist_ok=True)
    try:
        if archive.endswith((".tar.gz", ".tgz", ".tar.bz2", ".tar")):
            with tarfile.open(archive) as t:
                t.extractall(into)
        else:
            return False
        os.remove(archive)
        return True
    except Exception as e:  # noqa: BLE001
        _say(f"  extract failed: {e}")
        return False


def _git_clone(url: str, dest: str) -> bool:
    if os.path.exists(os.path.join(dest, ".git")):
        return True
    try:
        subprocess.run(["git", "clone", "--depth", "1", url, dest],
                       check=True, capture_output=True, timeout=1800)
        return True
    except Exception as e:  # noqa: BLE001
        _say(f"  git clone failed: {e}")
        return False


GDRIVE = "https://drive.google.com/uc?id="

# target -> (description, check paths, fetch fn, manual instructions)
# check paths are what the repo's loaders actually dereference:
#   clip_path (config/core.py:66), t2m_path (:73), smpl_path (:99),
#   word_vectorizer_path (:94), humanact12/uestc_rec_path (:76-77),
#   dataset roots (:86), released ckpt (scripts/parity_drill.py).
TARGETS = {}


def target(name, desc, checks, manual):
    def wrap(fn):
        TARGETS[name] = {"desc": desc, "checks": checks, "fetch": fn,
                         "manual": manual}
        return fn
    return wrap


@target("smpl", "SMPL body models (deps/smpl_models/smpl)",
        ["deps/smpl_models/smpl/SMPL_NEUTRAL.pkl"],
        "download smpl.tar.gz per reference prepare/download_smpl_model.sh "
        f"({GDRIVE}1qrFkPZyRwRGd0Q3EY76K8oJaIgs_WK9i), extract under deps/, "
        "then move smpl/ under deps/smpl_models/")
def _fetch_smpl():
    arc = os.path.join(REPO, "deps", "smpl.tar.gz")
    if not _download(GDRIVE + "1qrFkPZyRwRGd0Q3EY76K8oJaIgs_WK9i", arc):
        return False
    if not _extract(arc, os.path.join(REPO, "deps")):
        return False
    src = os.path.join(REPO, "deps", "smpl")
    dst = os.path.join(REPO, "deps", "smpl_models", "smpl")
    if os.path.isdir(src) and not os.path.isdir(dst):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.move(src, dst)
    return True


@target("clip", "CLIP ViT-L/14 HF clone (deps/clip-vit-large-patch14)",
        ["deps/clip-vit-large-patch14/config.json"],
        "git lfs install && git clone "
        "https://huggingface.co/openai/clip-vit-large-patch14 "
        "deps/clip-vit-large-patch14")
def _fetch_clip():
    return _git_clone("https://huggingface.co/openai/clip-vit-large-patch14",
                      os.path.join(REPO, "deps", "clip-vit-large-patch14"))


@target("t2m", "t2m evaluator checkpoints + meta (deps/t2m)",
        ["deps/t2m/t2m/text_mot_match/model/finest.tar",
         "deps/t2m/t2m/Comp_v6_KLD01/meta/mean.npy"],
        "download t2m.tar.gz per reference prepare/download_t2m_evaluators.sh "
        f"({GDRIVE}1AYsmEG8I3fAAoraT4vau0GnesWBWyeT8) and extract under deps/")
def _fetch_t2m():
    arc = os.path.join(REPO, "deps", "t2m.tar.gz")
    return (_download(GDRIVE + "1AYsmEG8I3fAAoraT4vau0GnesWBWyeT8", arc)
            and _extract(arc, os.path.join(REPO, "deps")))


@target("glove", "GloVe our_vab word vectors (deps/glove)",
        ["deps/glove/our_vab_data.npy", "deps/glove/our_vab_words.pkl",
         "deps/glove/our_vab_idx.pkl"],
        "clone https://github.com/EricGuo5513/HumanML3D and copy its glove/ "
        "to deps/glove/")
def _fetch_glove():
    tmp = os.path.join(REPO, "deps", "_humanml3d_repo")
    if not _git_clone("https://github.com/EricGuo5513/HumanML3D", tmp):
        return False
    src = os.path.join(tmp, "glove")
    dst = os.path.join(REPO, "deps", "glove")
    if os.path.isdir(src):
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
        return True
    return False


@target("ckpt", "released t2m checkpoint (models/mld_humanml3d_checkpoint)",
        ["models/mld_humanml3d_checkpoint/1222_mld_humanml3d_FID041.ckpt"],
        "download per reference prepare/download_pretrained_models.sh "
        f"({GDRIVE}1hplrnQwUK_cZFHirZIOuVP0RSyZEC1YM) into "
        "models/mld_humanml3d_checkpoint/")
def _fetch_ckpt():
    dst = os.path.join(REPO, "models", "mld_humanml3d_checkpoint",
                       "1222_mld_humanml3d_FID041.ckpt")
    return _download(GDRIVE + "1hplrnQwUK_cZFHirZIOuVP0RSyZEC1YM", dst)


@target("actiondata", "HumanAct12 + UESTC poses (datasets/)",
        ["datasets/HumanAct12Poses/humanact12poses.pkl"],
        "download per reference prepare/download_action_datasets.sh "
        f"(HumanAct12 {GDRIVE}1130gHSvNyJmii7f6pv5aY5IyQIWc3t7R, "
        f"UESTC {GDRIVE}1LE-EmYNzECU8o7A2DmqDKtqDMucnSJsy) into datasets/")
def _fetch_actiondata():
    arc = os.path.join(REPO, "datasets", "HumanAct12Poses.tar.gz")
    ok = (_download(GDRIVE + "1130gHSvNyJmii7f6pv5aY5IyQIWc3t7R", arc)
          and _extract(arc, os.path.join(REPO, "datasets")))
    arc2 = os.path.join(REPO, "datasets", "uestc.tar.bz2")
    ok2 = (_download(GDRIVE + "1LE-EmYNzECU8o7A2DmqDKtqDMucnSJsy", arc2)
           and _extract(arc2, os.path.join(REPO, "datasets")))
    return ok or ok2


@target("actionrec", "frozen a2m classifiers (deps/actionrecognition)",
        ["deps/actionrecognition/humanact12_gru.tar"],
        "wget https://raw.githubusercontent.com/EricGuo5513/action-to-motion/"
        "master/model_file/action_recognition_model_humanact12.tar -O "
        "deps/actionrecognition/humanact12_gru.tar; UESTC STGCN: "
        f"{GDRIVE}1bSSD69s1dHY7Uk0RGbGc6p7uhUxSDSBK")
def _fetch_actionrec():
    dst = os.path.join(REPO, "deps", "actionrecognition",
                       "humanact12_gru.tar")
    ok = _download(
        "https://raw.githubusercontent.com/EricGuo5513/action-to-motion/"
        "master/model_file/action_recognition_model_humanact12.tar", dst)
    dst2 = os.path.join(REPO, "deps", "actionrecognition",
                        "uestc_rot6d_stgcn.tar")
    ok2 = _download(GDRIVE + "1bSSD69s1dHY7Uk0RGbGc6p7uhUxSDSBK", dst2)
    return ok or ok2


def status(name: str) -> bool:
    return all(os.path.exists(os.path.join(REPO, c))
               for c in TARGETS[name]["checks"])


def main():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("targets", nargs="*", metavar="target",
                   help=f"targets to fetch, from: {', '.join(TARGETS)}")
    p.add_argument("--all", action="store_true", help="fetch every target")
    p.add_argument("--verify", action="store_true",
                   help="only print the readiness table")
    args = p.parse_args()

    unknown = [t for t in args.targets if t not in TARGETS]
    if unknown:
        p.error(f"unknown target(s) {unknown}; choose from {list(TARGETS)}")
    wanted = list(TARGETS) if args.all else list(args.targets)
    if not args.verify and wanted:
        online = _have_network()
        if not online:
            _say("no network egress detected — printing manual steps only")
        for name in wanted:
            t = TARGETS[name]
            if status(name):
                _say(f"{name}: already present")
                continue
            _say(f"{name}: {t['desc']}")
            ok = online and t["fetch"]()
            if ok and status(name):
                _say(f"{name}: OK")
            else:
                _say(f"{name}: NOT FETCHED — manual step:\n"
                     f"    {t['manual']}")

    print("\nreadiness:")
    ready = True
    for name, t in TARGETS.items():
        ok = status(name)
        ready &= ok or name in ("actiondata", "actionrec")
        print(f"  {'[x]' if ok else '[ ]'} {name:10s} {t['desc']}")
    hm3d = os.path.exists(os.path.join(REPO, "datasets", "humanml3d",
                                       "train.txt"))
    print(f"  {'[x]' if hm3d else '[ ]'} {'humanml3d':10s} HumanML3D dataset "
          "(license-gated: follow https://github.com/EricGuo5513/HumanML3D "
          "and place under datasets/humanml3d)")
    if ready and hm3d:
        print("\nall t2m parity assets present — run: "
              "python -m mld_tpu_torch.scripts.parity_drill --replications 20")
    return 0


if __name__ == "__main__":
    sys.exit(main())
