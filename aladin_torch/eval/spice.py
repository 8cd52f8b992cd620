"""SPICE metric + PTB tokenization via Java subprocesses (gated; a copy of
aladin_tpu/eval/spice.py).

Equivalent capability to ref:alad/evaluate_utils/spice.py:29-108 and
ptbtokenizer.py:19-67: both shell out to Java jars (spice-1.0.jar, Stanford
CoreNLP) over temp-file protocols. The jars are NOT bundled (the reference
fetches them with get_stanford_models.sh); every entry point raises a clear
error when they are absent. Host-side preprocessing only - never on the
device path (SURVEY.md S2.4).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

SPICE_JAR = os.environ.get("ALADIN_SPICE_JAR", "spice-1.0.jar")
CORENLP_JAR = os.environ.get(
    "ALADIN_CORENLP_JAR", "stanford-corenlp-3.4.1.jar"
)
# The JVM launcher argv prefix. Overridable (ALADIN_JAVA or monkeypatch) so
# the subprocess protocols can be exercised against a stub interpreter in CI
# where no JVM/jars exist - the temp-file formats, argv contracts, and output
# parsing below run for real either way (tests/test_spice_protocol.py).
JAVA = [os.environ.get("ALADIN_JAVA", "java")]


def _require(jar: str, what: str) -> str:
    if os.path.isfile(jar):
        return jar
    raise FileNotFoundError(
        f"{what} requires {jar!r}; fetch it (reference: "
        "alad/evaluate_utils/get_stanford_models.sh) and set the "
        f"ALADIN_{'SPICE' if 'spice' in what.lower() else 'CORENLP'}_JAR env var."
    )


def java_available() -> bool:
    return shutil.which("java") is not None


class PTBTokenizer:
    """Stanford PTB tokenization over a temp-file pipe
    (ref:ptbtokenizer.py:19-44 protocol)."""

    def tokenize(self, captions_for_image: Dict[str, List[dict]]) -> Dict[str, List[str]]:
        jar = _require(CORENLP_JAR, "PTB tokenization")
        image_ids = [k for k, v in captions_for_image.items() for _ in range(len(v))]
        sentences = "\n".join(
            c["caption"].replace("\n", " ").replace("\r", " ")
            for v in captions_for_image.values()
            for c in v
        )
        with tempfile.NamedTemporaryFile("w", delete=False, suffix=".txt") as f:
            f.write(sentences)
            path = f.name
        try:
            cmd = [
                *JAVA, "-cp", jar, "edu.stanford.nlp.process.PTBTokenizer",
                "-preserveLines", "-lowerCase", path,
            ]
            out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
        finally:
            os.remove(path)
        lines = out.rstrip("\n").split("\n")
        if len(lines) != len(image_ids):  # line drift would misassign every
            raise RuntimeError(           # following caption silently
                f"PTB tokenizer returned {len(lines)} lines for "
                f"{len(image_ids)} captions"
            )
        punct = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                 ".", "?", "!", ",", ":", "-", "--", "...", ";"}
        result: Dict[str, List[str]] = {}
        for img_id, line in zip(image_ids, lines):
            toks = " ".join(w for w in line.rstrip().split(" ") if w not in punct)
            result.setdefault(img_id, []).append(toks)
        return result


class Spice:
    """SPICE scorer (ref:spice.py:29-108 temp-file JSON protocol)."""

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[dict]]:
        jar = _require(SPICE_JAR, "SPICE scoring")
        input_data = []
        for img_id in sorted(gts.keys()):
            hypo = res[img_id]
            refs = gts[img_id]
            assert len(hypo) == 1 and len(refs) > 0
            input_data.append({"image_id": img_id, "test": hypo[0], "refs": refs})

        tmpdir = tempfile.mkdtemp()
        in_file = os.path.join(tmpdir, "in.json")
        out_file = os.path.join(tmpdir, "out.json")
        cache = os.path.join(tmpdir, "cache")
        os.makedirs(cache, exist_ok=True)
        with open(in_file, "w") as f:
            json.dump(input_data, f)
        try:
            subprocess.run(
                [*JAVA, "-jar", "-Xmx8G", jar, in_file, "-cache", cache,
                 "-out", out_file, "-subset", "-silent"],
                check=True,
            )
            with open(out_file) as f:
                results = json.load(f)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)

        import numpy as np

        scores = [float(item["scores"]["All"]["f"]) for item in results]
        return float(np.mean(scores)), results
