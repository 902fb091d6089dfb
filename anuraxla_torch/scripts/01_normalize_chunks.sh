#!/bin/bash
set -euo pipefail
source "$(dirname "$0")/_env.sh"
$ANURAXLA normalize --base-dir "$CHUNKS_ROOT" --device "$DEVICE_DEFAULT" "$@"
