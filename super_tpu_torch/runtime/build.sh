#!/bin/sh
# Build the native frame-loading runtime: sh build.sh OUTPUT.so
# (loader.py runs it at first use, with OUTPUT under build/runtime/).
set -e
case "$1" in
  /*) out="$1" ;;
  *) out="$PWD/$1" ;;
esac
cd "$(dirname "$0")"
g++ -O2 -fPIC -shared -std=c++17 frame_loader.cpp -o "$out" \
    -lpng -lz -lpthread
